"""MART inference and XML interop (the inference half of
quickrank_tpu/learning/mart.py).  Training waits for the training slice
(ROADMAP.md §A item 3).

Scorer dispatch depends on the model's shape only: the perfect-tree scorer
when every tree has depth <= 5, QuickScorer otherwise (any depth).  The
device then picks kernel or plain version inside the wrapper.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.ops.kernel_perfect import score_perfect
from quickrank_tpu_torch.ops.kernel_qs import score_qs
from quickrank_tpu_torch.trees.perfect import ensemble_to_perfect
from quickrank_tpu_torch.trees.qs import ensemble_to_qs
from quickrank_tpu_torch.trees.structs import EnsembleTensors

#: deepest tree the perfect-tree scorer embeds
PERFECT_MAX_DEPTH = 5


class Mart(LTRAlgorithm):
    NAME = "MART"

    def __init__(
        self,
        ntrees: int = 1000,
        shrinkage: float = 0.1,
        nthresholds: int = 255,
        nleaves: int = 10,
        minleafsupport: int = 1,
        esr: int = 100,
        subsample: float = 1.0,
        max_features: float = 1.0,
        seed: int = 0,
        max_depth: int = 0,
        collapse_leaves_factor: float = 0.0,
        growth: str = "best",
        cluster: str = "auto",
        split_pack: int = 4,
    ):
        """The JAX package's hyperparameters, kept so that a model's <info>
        survives a load and save through the port."""
        self.ntrees = int(ntrees)
        self.shrinkage = float(shrinkage)
        self.nthresholds = int(nthresholds)
        self.nleaves = int(nleaves)
        self.minleafsupport = int(minleafsupport)
        self.esr = int(esr)
        self.subsample = float(subsample)
        self.max_features = float(max_features)
        self.seed = int(seed)
        self.max_depth = int(max_depth)
        self.collapse_leaves_factor = float(collapse_leaves_factor)
        if growth == "best-k":
            growth = "bestk"
        if growth not in ("best", "level", "bestk"):
            raise ValueError(
                f"growth must be 'best', 'level' or 'bestk', got {growth!r}"
            )
        self.growth = growth
        self.split_pack = int(split_pack)
        if cluster not in ("auto", "on", "off"):
            raise ValueError(f"cluster must be auto/on/off, got {cluster!r}")
        self.cluster = cluster
        self.ensemble: Optional[EnsembleTensors] = None
        self._tables_cache = None

    def learn(self, train, valid=None, metric=None, verbose=True) -> dict:
        raise NotImplementedError(
            "training is not ported to quickrank_tpu_torch yet: ROADMAP.md "
            "§A item 3 (level-wise LambdaMART training slice)"
        )

    # -- inference -----------------------------------------------------------

    def _require_model(self) -> EnsembleTensors:
        if self.ensemble is None:
            raise RuntimeError(f"{self.NAME}: no trained model")
        return self.ensemble

    def _host_tables(self):
        """("perfect", PerfectEnsemble) when every tree has depth <= 5, else
        ("qs", QSEnsemble); host tensors, cached per ensemble."""
        ens = self._require_model()
        if self._tables_cache is None or self._tables_cache[0] is not ens:
            pe = ensemble_to_perfect(ens, max_depth=PERFECT_MAX_DEPTH)
            tables = ("perfect", pe) if pe is not None else ("qs", ensemble_to_qs(ens))
            self._tables_cache = (ens, tables)
        return self._tables_cache[1]

    def scorer_path(self) -> str:
        """Which scorer the dispatch picks: "perfect" or "qs"."""
        return self._host_tables()[0]

    def _dispatch_scorer(self, device):
        """(scorer_fn, model tables on ``device``)."""
        path, tables = self._host_tables()
        fn = score_perfect if path == "perfect" else score_qs
        return fn, tables.to(device)

    def device_scorer(self, ds: Dataset, device):
        """(fn, features on ``device``): ``fn`` maps the uploaded features to
        scores on the device, so timing loops upload once."""
        fn, tables = self._dispatch_scorer(device)
        X = torch.from_numpy(np.ascontiguousarray(ds.features, np.float32))
        return (lambda x: fn(x, tables)), X.to(device)

    def score_dataset(self, ds: Dataset, device="cpu") -> np.ndarray:
        fn, X = self.device_scorer(ds, device)
        return fn(X).cpu().numpy()

    def get_weights(self) -> np.ndarray:
        ens = self._require_model()
        return ens.weight[: ens.num_trees].cpu().numpy()

    # -- XML interop -----------------------------------------------------------

    def _info_dict(self) -> dict:
        """<ranker><info> payload (mart.cc:474-486, plus the JAX package's
        grower tags)."""
        return {
            "trees": self.ntrees,
            "leaves": self.nleaves,
            "shrinkage": self.shrinkage,
            "leafsupport": self.minleafsupport,
            "discretization": self.nthresholds,
            "estop": self.esr,
            "subsample": self.subsample,
            "max_features": self.max_features,
            "collapse_leaves_factor": self.collapse_leaves_factor,
            "growth": self.growth,
            "split_pack": self.split_pack,
            "max_depth": self.max_depth,
        }

    def _to_xml(self):
        from quickrank_tpu_torch.io.xml_model import ensemble_to_xml

        return ensemble_to_xml(self._require_model(), self._info_dict(), self.NAME)

    @staticmethod
    def _info_get(info, tag, cast, default):
        el = info.find(tag)
        return cast(el.text) if el is not None and el.text else default

    @classmethod
    def _ctor_kwargs_from_info(cls, info) -> dict:
        g = cls._info_get
        return dict(
            ntrees=g(info, "trees", int, 1000),
            shrinkage=g(info, "shrinkage", float, 0.1),
            nthresholds=g(info, "discretization", int, 255),
            nleaves=g(info, "leaves", int, 10),
            minleafsupport=g(info, "leafsupport", int, 1),
            esr=g(info, "estop", int, 100),
            subsample=g(info, "subsample", float, 1.0),
            max_features=g(info, "max_features", float, 1.0),
            growth=g(info, "growth", str, "best"),
            split_pack=g(info, "split_pack", int, 4),
            max_depth=g(info, "max_depth", int, 0),
        )

    @classmethod
    def _from_xml(cls, root):
        from quickrank_tpu_torch.io.xml_model import parse_ensemble

        algo = cls(**cls._ctor_kwargs_from_info(root.find("info")))
        algo.ensemble, _ = parse_ensemble(root)
        return algo

    def __repr__(self):
        return (
            f"{self.NAME}(ntrees={self.ntrees}, shrinkage={self.shrinkage}, "
            f"nleaves={self.nleaves}, minls={self.minleafsupport}, "
            f"nthresholds={self.nthresholds}, esr={self.esr}, "
            f"subsample={self.subsample}, max_features={self.max_features})"
        )
