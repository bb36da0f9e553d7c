"""Runnable examples of the port's partitioner, the torch versions of the
JAX package's ``examples/quickstart.py``, ``partition_snn.py`` and
``moe_placement.py``:

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

Without ``--device`` they run on CUDA and raise where there is none."""
