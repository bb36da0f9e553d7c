"""Assigned architecture config: qwen2-1.5b (see registry.py for the
exact hyperparameters and source citation)."""
from repro_torch.configs.registry import get_config

ARCH = "qwen2-1.5b"
CONFIG = get_config(ARCH)
SMOKE = CONFIG.smoke()
