"""Assigned architecture config: jamba-v0.1-52b (see registry.py for the
exact hyperparameters and source citation)."""
from repro_torch.configs.registry import get_config

ARCH = "jamba-v0.1-52b"
CONFIG = get_config(ARCH)
SMOKE = CONFIG.smoke()
