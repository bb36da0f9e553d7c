"""Assigned architecture config: xlstm-350m (see registry.py for the
exact hyperparameters and source citation)."""
from repro_torch.configs.registry import get_config

ARCH = "xlstm-350m"
CONFIG = get_config(ARCH)
SMOKE = CONFIG.smoke()
