"""Assigned architecture config: minitron-8b (see registry.py for the
exact hyperparameters and source citation)."""
from repro_torch.configs.registry import get_config

ARCH = "minitron-8b"
CONFIG = get_config(ARCH)
SMOKE = CONFIG.smoke()
