"""Core scalar types and constants (counterpart of quickrank_tpu/types.py).

Host-side arrays are numpy; device tensors are torch float32/int32.
"""

from __future__ import annotations

import numpy as np

LABEL_DTYPE = np.float32
FEATURE_DTYPE = np.float32
SCORE_DTYPE = np.float32
QID_DTYPE = np.int64

# Sentinel used in padded gather maps and node ids.
INVALID = -1

# "No cutoff" sentinel mirroring metric.h's NO_CUTOFF.
NO_CUTOFF = 1 << 30
