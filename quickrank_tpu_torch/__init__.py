"""PyTorch + CUDA port of quickrank_tpu for NVIDIA Hopper (H100).

The JAX package ``quickrank_tpu`` stays the reference; this package mirrors
its module paths.  Plain tensor code is PyTorch; every Pallas kernel on a
ported path is a hand-written CUDA C++ kernel under ``csrc/``, compiled with
nvcc on first use (``ops/_cuda.py``).  A wrapper given a CPU tensor runs the
kernel's plain PyTorch version; given a CUDA tensor it launches the kernel
or raises.

Ported so far: the scoring path (``quickscore``): SVML and XML model I/O,
``Mart``/``LambdaMart`` inference, and the QuickScorer and perfect-tree
kernels.  ROADMAP.md lists what follows.
"""
