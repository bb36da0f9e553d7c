"""Assigned architecture config: whisper-tiny (see registry.py for the
exact hyperparameters and source citation)."""
from repro_torch.configs.registry import get_config

ARCH = "whisper-tiny"
CONFIG = get_config(ARCH)
SMOKE = CONFIG.smoke()
