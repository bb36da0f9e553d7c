"""Runnable examples of the port, the torch versions of the JAX package's
``examples/quickstart.py``, ``partition_snn.py``, ``moe_placement.py``,
``serve_lm.py`` and ``train_lm.py``:

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

Without ``--device`` they run on CUDA and raise where there is none."""
