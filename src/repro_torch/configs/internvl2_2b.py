"""Assigned architecture config: internvl2-2b (see registry.py for the
exact hyperparameters and source citation)."""
from repro_torch.configs.registry import get_config

ARCH = "internvl2-2b"
CONFIG = get_config(ARCH)
SMOKE = CONFIG.smoke()
