"""PyTorch + CUDA port of quickrank_tpu for NVIDIA Hopper (H100).

The JAX package ``quickrank_tpu`` stays the reference; this package mirrors
its module paths.  Plain tensor code is PyTorch; every Pallas kernel on a
ported path is a hand-written CUDA C++ kernel under ``csrc/``, compiled with
nvcc on first use (``ops/_cuda.py``).  A wrapper given a CPU tensor runs the
kernel's plain PyTorch version; given a CUDA tensor it launches the kernel
or raises.

Ported: scoring (``quickscore``: SVML and XML model I/O, the
QuickScorer, perfect-tree and oblivious bit-OR kernels), training of
``Mart``/``LambdaMart`` (best-first, best-k and level-wise growth, warm
start), ``ObliviousMart``/``ObliviousLambdaMart`` and ``Dart`` on the
histogram kernels, the linear rankers ``CoordinateAscent``/``LineSearch``,
and post-learning pruning (``optimization.Cleaver``, ``MetaCleaver``) on
the QuickScorer kernel's per-tree scores, and every other learner of the
JAX package; query-sharded and data x feature sharded training
(``parallel/``); the C code generators and the scorer export
(``io/export.py``: a ``torch.export`` archive that serves with torch
alone).  Entry points run on the CUDA card unless given ``device="cpu"``.
"""

from quickrank_tpu_torch.learning import (  # noqa: F401
    LambdaMart,
    LTRAlgorithm,
    Mart,
    ObliviousLambdaMart,
    ObliviousMart,
)
