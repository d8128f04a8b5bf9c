"""Oblivious MART and Oblivious LambdaMART: boosting of symmetric trees
(counterpart of quickrank_tpu/learning/obliviousmart.py, after
src/learning/forests/obliviousmart.cc and obliviouslambdamart.cc).

The boosting loops are Mart's and LambdaMart's; the regressor is the
level-synchronous oblivious tree (``trees/oblivious.py``, ot.cc).  A fitted
tree is stored in the shared dense ensemble layout, as the perfect binary
tree that repeats one (feature, threshold) per level, so XML, rollback and
warm start are Mart's.  Inference goes through the bit-OR scorer
(``ops/kernel_oblivious.py``): the CUDA kernel on the card, its plain
version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from quickrank_tpu_torch.learning.lambdamart import LambdaMart
from quickrank_tpu_torch.learning.mart import Mart, TrainData
from quickrank_tpu_torch.ops.kernel_oblivious import score_oblivious
from quickrank_tpu_torch.trees.oblivious import (
    DEAD_BIN,
    FLT_MAX,
    ObliviousEnsemble,
    fit_oblivious_tree,
    oblivious_to_tree,
)


class _ObliviousFit:
    """Mixin: the oblivious fit in place of the best-first grower, and the
    bit-OR scorer for inference."""

    def __init__(self, *args, treedepth: int = 4, **kw):
        super().__init__(*args, **kw)
        self.treedepth = int(treedepth)
        # nleaves sets the ensemble's node capacity: a depth-D oblivious
        # tree is a perfect tree with 2^D leaves
        self.nleaves = 2 ** self.treedepth
        self._obl_cache = None

    def _grower_depth(self) -> int:
        return self.treedepth + 1

    def _info_dict(self) -> dict:
        d = super()._info_dict()
        d["depth"] = self.treedepth  # obliviousmart.cc:77
        return d

    @classmethod
    def _ctor_kwargs_from_info(cls, info) -> dict:
        kw = super()._ctor_kwargs_from_info(info)
        kw.pop("nleaves", None)  # derived from the depth
        kw["treedepth"] = cls._info_get(info, "depth", int, 4)
        return kw

    def _fit_and_assign(self, tr: TrainData, grad, smask, cfg, generator,
                        weights=None):
        sd = tr.step
        fid, thr, tbin, leafidx = fit_oblivious_tree(
            sd.binned, grad, smask, sd.thresholds, self.treedepth,
            min_leaf_support=self.minleafsupport, group=tr.group, num_docs=cfg.num_docs,
            feat=tr.feat,
        )
        L = 2 ** self.treedepth
        tree = oblivious_to_tree(
            fid, thr, tbin, torch.zeros(L, dtype=torch.float32, device=fid.device))
        # leaf node ids in the perfect-tree layout: internal nodes take
        # [0, L-1), leaf l is node (L-1) + l.  Every doc is routed; the
        # sample mask only gates the statistics.
        return tree, (L - 1) + leafidx, False

    # -- inference -----------------------------------------------------------

    def oblivious_ensemble(self) -> ObliviousEnsemble:
        """The [T, D] level tables of the stored symmetric trees (host
        tensors, cached per ensemble).

        It does not depend on how nodes are numbered, so it reads freshly
        trained heap-layout trees and XML-loaded pre-order ones alike: per
        level, (feature, threshold) is read off the leftmost path, and leaf
        ``l`` is reached by walking ``l``'s bits.  A shallower tree keeps
        dead levels (FLT_MAX thresholds) below its leaves."""
        ens = self._require_model()
        if self._obl_cache is not None and self._obl_cache[0] is ens:
            return self._obl_cache[1]
        T = ens.num_trees
        D = self.treedepth
        L = 2 ** D
        h = ens.numpy()
        feat, thrv, tbv = h["feature"], h["threshold"], h["threshold_bin"]
        lft, rgt, lv, isl = h["left"], h["right"], h["leaf_value"], h["is_leaf"]

        fid = np.zeros((T, D), np.int32)
        thr = np.full((T, D), FLT_MAX, np.float32)
        tbin = np.full((T, D), DEAD_BIN, np.int32)
        leaf = np.zeros((T, L), np.float32)
        for t in range(T):
            node = 0
            for d in range(D):
                if isl[t, node]:
                    break
                fid[t, d] = feat[t, node]
                thr[t, d] = thrv[t, node]
                tbin[t, d] = tbv[t, node]
                node = lft[t, node]
            for l in range(L):
                node = 0
                for d in range(D):
                    if isl[t, node]:
                        break
                    node = rgt[t, node] if (l >> (D - 1 - d)) & 1 else lft[t, node]
                leaf[t, l] = lv[t, node]
        obl = ObliviousEnsemble.from_numpy(dict(
            fid=fid, thr=thr, thr_bin=tbin, leaf=leaf, weight=h["weight"][:T],
            num_trees=T))
        self._obl_cache = (ens, obl)
        return obl

    def scorer_path(self) -> str:
        return "oblivious"

    def _dispatch_scorer(self, device):
        """Oblivious models always take the bit-OR scorer, never the
        perfect-tree one their embedding would also fit."""
        return score_oblivious, self.oblivious_ensemble().to(device)


class ObliviousMart(_ObliviousFit, Mart):
    NAME = "OBVMART"


class ObliviousLambdaMart(_ObliviousFit, LambdaMart):
    NAME = "OBVLAMBDAMART"
