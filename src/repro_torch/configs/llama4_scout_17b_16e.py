"""Assigned architecture config: llama4-scout-17b-16e (see registry.py for the
exact hyperparameters and source citation)."""
from repro_torch.configs.registry import get_config

ARCH = "llama4-scout-17b-16e"
CONFIG = get_config(ARCH)
SMOKE = CONFIG.smoke()
