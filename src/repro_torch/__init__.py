"""PyTorch/CUDA port of the constrained multilevel hypergraph partitioner.

The package mirrors ``repro`` module by module for the single-device
V-cycle (``core.partitioner.partition``). It imports ``torch`` and numpy
only; the hot loops (pair scores, pins counts, gains) run as hand-written
CUDA kernels for Hopper (``csrc/``) when their tensors lie on a CUDA
device, and as plain PyTorch when they lie on the CPU.
"""
