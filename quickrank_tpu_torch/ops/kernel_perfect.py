"""Perfect-tree scoring: the CUDA kernel ``csrc/perfect_score.cu`` and its
plain version (``trees/perfect.py::score_perfect``).

Replaces quickrank_tpu/ops/pallas_perfect.py::score_perfect_pallas: the same
plain float32 sum of ``wleaf[t, leaf]``, in tree order.  The kernel stages a
block's document rows and a tile of the packed tables
(``PerfectEnsemble.packed``) in shared memory; the plain scorer reads the
unpacked tables.
"""

from __future__ import annotations

import torch

from quickrank_tpu_torch.ops import _cuda
from quickrank_tpu_torch.ops.kernel_qs import check_inputs
from quickrank_tpu_torch.trees.perfect import PerfectEnsemble
from quickrank_tpu_torch.trees.perfect import score_perfect as plain_score_perfect

#: kernel launches by this wrapper; a run that must show its path went
#: through the kernel sets it to 0 first and reads it after
LAUNCHES = 0


def score_perfect(features: torch.Tensor, pe: PerfectEnsemble) -> torch.Tensor:
    """Weighted ensemble scores f32 [N].  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises."""
    global LAUNCHES
    check_inputs(features, pe, "score_perfect")
    if features.device.type == "cpu":
        return plain_score_perfect(features, pe)
    N, F = features.shape
    out = torch.empty(N, dtype=torch.float32, device=features.device)
    if N == 0:
        return out
    packed = pe.packed()
    lib = _cuda.library()
    rc = lib.perfect_score(
        features.data_ptr(), N, F, packed.data_ptr(), int(packed.shape[0]),
        pe.depth, int(packed.shape[1]), out.data_ptr(),
        torch.cuda.current_stream(features.device).cuda_stream,
    )
    _cuda.check(rc, "perfect_score")
    LAUNCHES += 1
    return out
