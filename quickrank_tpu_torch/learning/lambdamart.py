"""LambdaMART (counterpart of quickrank_tpu/learning/lambdamart.py, after
src/learning/forests/lambdamart.cc): Mart with the pairwise lambda
gradients of ``ops/lambdas.py`` in place of the pointwise pseudoresponses,
and Newton leaf outputs sum(lambda)/sum(w) (lambdamart.cc:47-60 ->
rt.cc:186-207).

Subsampling follows the reference's query "cleaning" (lambdamart.cc:85-108):
lambdas are computed among the sampled docs of each query only.
"""

from __future__ import annotations

from typing import Optional

import torch

from quickrank_tpu_torch.data.dataset import gather_padded, gather_unpad
from quickrank_tpu_torch.learning.mart import Mart, StepData
from quickrank_tpu_torch.ops.lambdas import lambda_gradients


class LambdaMart(Mart):
    NAME = "LAMBDAMART"
    _newton = True

    def __init__(self, *args, query_chunk: Optional[int] = None, **kw):
        """``query_chunk`` bounds the queries of one lambda pair block."""
        super().__init__(*args, **kw)
        self.query_chunk = query_chunk

    def _gradients(self, sd: StepData, scores, sample_mask, full_mask=False):
        """Lambdas and Newton weights of the training metric's swap deltas
        (lambdamart.cc:110 uses the training scorer's jacobian), in flat
        padded order.  With ``full_mask`` the sample is every doc, so the
        slot mask serves as is."""
        s = gather_padded(scores, sd.pad_index, sd.slot_mask)
        if full_mask:
            slot_mask, nvalid = sd.slot_mask, sd.nvalid
        else:
            present = gather_padded(sample_mask, sd.pad_index, sd.slot_mask,
                                    fill=False)
            slot_mask = sd.slot_mask & present
            nvalid = slot_mask.sum(-1).to(torch.int32)
        lam, w = lambda_gradients(s, sd.labels2d, slot_mask, nvalid,
                                  self._train_metric, self.query_chunk)
        lw = gather_unpad(torch.stack([lam, w], dim=-1), sd.inv_q, sd.inv_slot,
                          sd.doc_mask)
        return lw[..., 0], lw[..., 1]
