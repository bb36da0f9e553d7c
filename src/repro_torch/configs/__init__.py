"""Architecture configurations: the JAX package's ``configs/base.py`` and
``configs/registry.py``, copied as data (the port imports nothing of it)."""
from repro_torch.configs.registry import get_config, list_configs  # noqa: F401
