"""Assigned architecture config: yi-34b (see registry.py for the
exact hyperparameters and source citation)."""
from repro_torch.configs.registry import get_config

ARCH = "yi-34b"
CONFIG = get_config(ARCH)
SMOKE = CONFIG.smoke()
