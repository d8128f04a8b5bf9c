"""The 95th percentile, over every batch of the window, of a batch's time
from its dispatch to its scores in pinned host memory (CUDA events on the
device's clock: one on an idle side stream at dispatch, one after the
copy)."""

import numpy as np


def read(ctx):
    ms = ctx.window.get("batch_ms")
    return float(np.percentile(ms, 95)) if ms else None
