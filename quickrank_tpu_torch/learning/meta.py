"""MetaCleaver (X-CLEaVER), the grow-and-prune meta-algorithm (counterpart
of quickrank_tpu/learning/meta.py, after src/learning/meta/
meta_cleaver.cc:118-373).

It wraps a Mart-family learner and a Cleaver optimizer.  Each
meta-iteration (1) warm-starts the learner for ``ntrees_per_iter`` more
trees, (2) runs Cleaver on the per-tree score matrix to prune
``pruning_rate_per_iter`` of the new trees and re-weight them, and (3)
keeps the result only if the metric improved (``opt_last_only`` allows
backtracking), until ``final_ntrees`` trees or an early stop; at the end the
trees added after the best model are masked away (meta_cleaver.cc:337-347).
Everything runs on the ``device`` given to :meth:`MetaCleaver.learn`, or,
under a query-sharded group, on each rank's block: the learner and Cleaver
both train under it, and every rank keeps the same model.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.learning.base import LTRAlgorithm, resolve_device
from quickrank_tpu_torch.learning.linear import refuse_mesh
from quickrank_tpu_torch.metrics.metrics import Metric


class MetaCleaver(LTRAlgorithm):
    NAME = "METACLEAVER"

    def __init__(self, ltr_algo, cleaver, final_ntrees: int = 1000,
                 ntrees_per_iter: int = 100, pruning_rate_per_iter: float = 0.5,
                 opt_last_only: bool = True, meta_esr: int = 0, meta_verbose: bool = False):
        self.ltr_algo = ltr_algo
        self.cleaver = cleaver
        self.final_ntrees = int(final_ntrees)
        self.ntrees_per_iter = int(ntrees_per_iter)
        self.pruning_rate_per_iter = float(pruning_rate_per_iter)
        self.opt_last_only = bool(opt_last_only)
        self.meta_esr = int(meta_esr)
        self.meta_verbose = bool(meta_verbose)
        self.history: dict = {}

    def _ensemble_size(self) -> int:
        ens = self.ltr_algo.ensemble
        return int(ens.num_trees) if ens is not None else 0

    def learn(self, train: Dataset, valid: Optional[Dataset] = None,
              metric: Optional[Metric] = None, verbose: bool = True, device=None,
              mesh=None) -> dict:
        """Grow and prune on ``device`` (the CUDA card by default, or "cpu"),
        or on this rank's block under ``mesh`` (a ``parallel.DataGroup``).
        Returns ``{"iterations": [...], "best_train", "best_valid",
        "final_size"}``."""
        refuse_mesh(mesh)
        device = mesh.device if mesh is not None else resolve_device(device)
        verbose = verbose and (mesh is None or mesh.rank == 0)
        metric = metric or self.default_metric()
        algo, cleaver = self.ltr_algo, self.cleaver
        cleaver.update_model = False  # the meta loop applies the weights

        meta_esr = self.meta_esr
        if not self.opt_last_only:
            # no backtracking when the whole model is optimized each
            # iteration (meta_cleaver.cc:148-151)
            meta_esr = 1

        best_tr, best_va = -np.inf, -np.inf
        best_model = self._ensemble_size()
        best_weights = algo.get_weights().copy() if best_model > 0 else np.zeros(0)
        best_iter, it, hist = 0, 0, []
        while True:
            it += 1
            if meta_esr and it > best_iter + meta_esr:
                break
            last_size = self._ensemble_size()

            # ntrees_per_iter more trees, without valid: the meta loop stops early
            algo.ntrees = last_size + self.ntrees_per_iter
            algo.learn(train, None, metric, verbose=self.meta_verbose, device=device,
                       warm_start=True, mesh=mesh)
            new_size = self._ensemble_size()
            diff = new_size - last_size
            if diff == 0:
                break

            if self.pruning_rate_per_iter < 1:
                trees_to_keep = int(round((1.0 - self.pruning_rate_per_iter)
                                          * self.ntrees_per_iter))
            else:
                trees_to_keep = self.ntrees_per_iter - int(self.pruning_rate_per_iter)
                if trees_to_keep < 0:
                    raise ValueError("pruning rate per iter too high")
            trees_to_prune = diff - trees_to_keep
            if new_size - trees_to_prune > self.final_ntrees:
                trees_to_prune = new_size - self.final_ntrees
            trees_to_prune = max(trees_to_prune, 0)

            cleaver.pruning_rate = float(trees_to_prune)
            cleaver.update_weights(algo.get_weights())
            if self.opt_last_only:
                cleaver.last_estimators_to_optimize = diff
            if cleaver.line_search is not None:
                cleaver.line_search.reset_weights()
            cleaver.optimize(algo, train, valid, metric, verbose=self.meta_verbose,
                             device=device, mesh=mesh)

            improvement = False
            if valid is not None:
                if cleaver.metric_on_validation_ > best_va:
                    best_va = cleaver.metric_on_validation_
                    best_tr = cleaver.metric_on_training_
                    improvement = True
            elif cleaver.metric_on_training_ > best_tr:
                best_tr = cleaver.metric_on_training_
                improvement = True

            if improvement or self.opt_last_only:
                algo.update_weights(cleaver.weights_)
            if not improvement and not self.opt_last_only:
                break

            cur_size = self._ensemble_size()
            if improvement:
                best_model, best_iter = cur_size, it
                best_weights = algo.get_weights().copy()
            hist.append({
                "iter": it, "size": cur_size, "train": cleaver.metric_on_training_,
                "valid": cleaver.metric_on_validation_ if valid is not None else None,
                "improved": improvement,
            })
            if verbose:
                vtxt = (f" valid {cleaver.metric_on_validation_:.4f}"
                        if valid is not None else "")
                print(f"# meta-iter {it}: size={cur_size} train "
                      f"{cleaver.metric_on_training_:.4f}{vtxt}{' *' if improvement else ''}")
            if cur_size >= self.final_ntrees:
                break

        # back to the best model (meta_cleaver.cc:337-347)
        cur_size = self._ensemble_size()
        if cur_size > best_model:
            mask = np.zeros(cur_size)
            mask[:best_model] = best_weights[:best_model]
            algo.update_weights(mask)

        self.history = {
            "iterations": hist,
            "best_train": best_tr,
            "best_valid": best_va if valid is not None else None,
            "final_size": self._ensemble_size(),
        }
        return self.history

    # -- delegation ----------------------------------------------------------

    def scorer_path(self) -> str:
        return self.ltr_algo.scorer_path()

    def device_scorer(self, ds: Dataset, device=None):
        return self.ltr_algo.device_scorer(ds, device)

    def score_dataset(self, ds: Dataset, device=None) -> np.ndarray:
        return self.ltr_algo.score_dataset(ds, device)

    def partial_scores_dataset(self, ds: Dataset, device=None) -> np.ndarray:
        return self.ltr_algo.partial_scores_dataset(ds, device)

    def get_weights(self) -> np.ndarray:
        return self.ltr_algo.get_weights()

    def update_weights(self, w) -> None:
        self.ltr_algo.update_weights(w)

    def _to_xml(self):
        """Composite model XML: the meta info and the inner model
        (meta_cleaver.cc:75-105 wraps the LtR model, Cleaver and the line
        search)."""
        import xml.etree.ElementTree as ET

        root = ET.Element("ranker")
        info = ET.SubElement(root, "info")
        ET.SubElement(info, "type").text = self.NAME
        ET.SubElement(info, "final-num-trees").text = str(self.final_ntrees)
        ET.SubElement(info, "num-trees-per-iter").text = str(self.ntrees_per_iter)
        ET.SubElement(info, "pruning-rate-per-iter").text = str(self.pruning_rate_per_iter)
        ET.SubElement(info, "opt-last-only").text = str(int(self.opt_last_only))
        inner = self.ltr_algo._to_xml()
        inner.tag = "ltr-model"
        root.append(inner)
        return root

    @classmethod
    def _from_xml(cls, root):
        from quickrank_tpu_torch.io.xml_model import load_element
        from quickrank_tpu_torch.optimization.cleaver import Cleaver

        info = root.find("info")

        def g(tag, cast, default):
            el = info.find(tag)
            return cast(el.text) if el is not None else default

        return cls(
            ltr_algo=load_element(root.find("ltr-model")),
            cleaver=Cleaver(),
            final_ntrees=g("final-num-trees", int, 1000),
            ntrees_per_iter=g("num-trees-per-iter", int, 100),
            pruning_rate_per_iter=g("pruning-rate-per-iter", float, 0.5),
            opt_last_only=g("opt-last-only", lambda s: bool(int(s)), True),
        )
