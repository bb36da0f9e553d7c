"""Assigned architecture config: phi4-mini-3.8b (see registry.py for the
exact hyperparameters and source citation)."""
from repro_torch.configs.registry import get_config

ARCH = "phi4-mini-3.8b"
CONFIG = get_config(ARCH)
SMOKE = CONFIG.smoke()
