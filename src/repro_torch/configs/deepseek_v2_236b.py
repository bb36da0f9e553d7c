"""Assigned architecture config: deepseek-v2-236b (see registry.py for the
exact hyperparameters and source citation)."""
from repro_torch.configs.registry import get_config

ARCH = "deepseek-v2-236b"
CONFIG = get_config(ARCH)
SMOKE = CONFIG.smoke()
