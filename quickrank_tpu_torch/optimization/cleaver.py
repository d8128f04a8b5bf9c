"""CLEAVER: ensemble pruning and line-search re-weighting (counterpart of
quickrank_tpu/optimization/cleaver.py, after src/optimization/post_learning/
cleaver/cleaver.cc:166-418 and its eight pruning strategies).

Everything works on the per-tree score matrix ``P [docs, trees]`` of a
model (``partial_scores_dataset``: the QuickScorer kernel's partial entry
on the card), held on the device by a :class:`~quickrank_tpu_torch.learning.
linear.Fold`.  A strategy's candidate models are score vectors built from
it and evaluated in byte-bounded batches; the selections themselves stay on
the host, with the JAX package's numpy calls, so RANDOM and RANDOM_ADV draw
its sets exactly.

Flow (cleaver.cc:166-418):
  1. the weights are the algorithm's (or preset ones);
  2. a weight-sensitive strategy (LOW_WEIGHTS, QUALITY_LOSS(_ADV),
     SCORE_LOSS) first runs the line search, or reuses a loaded one's
     weights rescaled to the model's magnitude;
  3. the strategy picks ``estimators_to_prune`` trees of the last
     ``last_estimators_to_optimize``;
  4. the survivors get their weights from before the line search back,
     the pruned ones zero;
  5. an optional line search re-weights the column-filtered matrix;
  6. ``algo.update_weights`` writes back, dropping zero-weight trees.

Query-sharded (``optimize(mesh=group)``, a ``parallel.DataGroup``; JAX
cleaver.py:58-131): each rank extracts the per-tree matrix of its own block
of the queries (K1's partial entry on its rows) and holds it in its
``Fold``; every candidate metric and the SCORE_LOSS sums cross ranks in
gathers that leave them one rank's values bit for bit (``Fold.metrics``,
``Fold.doc_sums``), so every rank prunes the same set and keeps the same
weights.  Rank 0 alone prints.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import Dataset, rank_block
from quickrank_tpu_torch.learning.base import resolve_device
from quickrank_tpu_torch.learning.linear import Fold, LineSearch
from quickrank_tpu_torch.learning.mart import refuse_mesh
from quickrank_tpu_torch.parallel.mesh import data_group
from quickrank_tpu_torch.metrics.metrics import Metric
from quickrank_tpu_torch.ops.scoring import fma_f32

PRUNING_METHODS = (
    "RANDOM",
    "RANDOM_ADV",
    "LOW_WEIGHTS",
    "SKIP",
    "LAST",
    "QUALITY_LOSS",
    "QUALITY_LOSS_ADV",
    "SCORE_LOSS",
)

#: strategies that need line-search weights before pruning (cleaver.cc:44-47)
_PRE_LS = {"LOW_WEIGHTS", "QUALITY_LOSS", "QUALITY_LOSS_ADV", "SCORE_LOSS"}

#: columns of the per-tree matrix that :meth:`_PartialEval.mask_metrics`
#: casts to float64 at once (0.65 GB at 2.56M docs)
_MASK_COLUMNS = 32


class _PartialEval:
    """Metric evaluation over a per-tree score dataset on one device: the
    primitives of the quality-aware strategies (quality_loss_pruning.cc:
    49-79, random_adv_pruning.cc:43-76, score_loss_pruning.cc:58-77).
    Candidates are built a batch at a time (``Fold.batch_size``), so peak
    memory does not grow with the number of trees, and each candidate's
    metric does not depend on the batch it was evaluated in.  Under a
    ``group`` the fold is this rank's block."""

    def __init__(self, metric: Metric, ds: Dataset, device, group=None):
        self.metric = metric
        self.fold = Fold(ds, device, group)
        self.num_trees = ds.num_features

    def base(self, w) -> torch.Tensor:
        return self.fold.dot(w)

    def metric_of(self, scores) -> float:
        return self.fold.metric(self.metric, scores)

    def metric_of_weights(self, w) -> float:
        return self.metric_of(self.base(w))

    def _weights(self, w) -> torch.Tensor:
        return torch.from_numpy(np.asarray(w, np.float32)).to(self.fold.device)

    def drop_one_metrics(self, base, w, start: int = 0) -> np.ndarray:
        """Metric after removing tree f, for f in [start, T): float32
        ``[T - start]`` host array (writable: QUALITY_LOSS_ADV masks picked
        entries).  ``base - w_f * P[:, f]`` is one fused multiply-add, as
        XLA fuses it, so given JAX's base the candidates are JAX's."""
        w32 = self._weights(w)
        n = self.fold.batch_size()
        out = []
        for f0 in range(start, self.num_trees, n):
            f1 = min(self.num_trees, f0 + n)
            cols = self.fold.X[:, f0:f1].T
            out.append(self.fold.metrics(self.metric,
                                         fma_f32(-w32[f0:f1, None], cols, base[None, :])))
        return torch.cat(out).cpu().numpy() if out else np.zeros(0, np.float32)

    def apply_drop(self, base, w, f: int) -> torch.Tensor:
        return fma_f32(-self._weights(w)[f], self.fold.column(f), base)

    def mask_metrics(self, base, w, masks) -> np.ndarray:
        """Metric after removing each row-mask's tree set: float32 ``[B]``.
        ``base - P @ (w * m_b)``, the product summed in float64 tree by tree
        (elementwise, so a doc's sum does not depend on the rows beside it;
        :data:`_MASK_COLUMNS` columns cast at a time, so memory does not
        grow with the trees) and rounded once."""
        w64 = torch.from_numpy(np.asarray(w, np.float32).astype(np.float64)).to(self.fold.device)
        m = torch.from_numpy(np.asarray(masks, np.float32).astype(np.float64)).to(self.fold.device)
        X = self.fold.X
        n = self.fold.batch_size()
        out = []
        for b0 in range(0, m.shape[0], n):
            wm = w64[:, None] * m[b0:b0 + n].T
            delta = torch.zeros((X.shape[0], wm.shape[1]), dtype=torch.float64, device=X.device)
            for c0 in range(0, self.num_trees, _MASK_COLUMNS):
                cols = X[:, c0:c0 + _MASK_COLUMNS].double()
                for j in range(cols.shape[1]):
                    delta.addcmul_(cols[:, j:j + 1], wm[c0 + j][None, :])
            out.append(self.fold.metrics(self.metric, base[None, :] - delta.float().T))
        return torch.cat(out).cpu().numpy()

    def score_loss_sums(self, base, w) -> np.ndarray:
        """Per tree, the sum over docs of ``w_f * P[d, f] / score_d``
        (score_loss_pruning.cc:58-77's formula; padding rows are zero):
        float64 ``[T]``, the float32 terms summed in float64 by query and
        then over the queries (``Fold.doc_sums``)."""
        safe = torch.where(base == 0, torch.tensor(1e-12, device=base.device), base)
        w32 = self._weights(w)
        n = self.fold.batch_size()
        out = []
        for f0 in range(0, self.num_trees, n):
            terms = (self.fold.X[:, f0:f0 + n] * w32[None, f0:f0 + n]) / safe[:, None]
            out.append(self.fold.doc_sums(terms.double()))
        return torch.cat(out).cpu().numpy()


class Cleaver:
    """Post-learning pruning and re-weighting of a tree ensemble, with the
    optimizer interface of include/optimization/optimization.h:19-55."""

    NAME = "CLEAVER"

    def __init__(self, pruning_method: str = "QUALITY_LOSS", pruning_rate: float = 0.5,
                 line_search: Optional[LineSearch] = None,
                 last_estimators_to_optimize: int = 0, seed: int = 0):
        method = pruning_method.upper()
        if method not in PRUNING_METHODS:
            raise ValueError(
                f"unknown pruning method {method!r}; known: {PRUNING_METHODS}"
            )
        self.pruning_method = method
        self.pruning_rate = float(pruning_rate)
        self.line_search = line_search
        self.last_estimators_to_optimize = int(last_estimators_to_optimize)
        self.seed = int(seed)
        self.weights_: Optional[np.ndarray] = None
        #: MetaCleaver takes over applying the weights (meta_cleaver.cc:163)
        self.update_model = True
        self.metric_on_training_: float = float("-inf")
        self.metric_on_validation_: float = float("-inf")

    def line_search_pre_pruning(self) -> bool:
        return self.pruning_method in _PRE_LS

    def update_weights(self, weights) -> None:
        self.weights_ = np.asarray(weights, np.float64).copy()

    @staticmethod
    def partial_dataset(algo, ds: Dataset, device=None, group=None) -> Dataset:
        """Per-tree score dataset, rows docs and columns trees
        (Driver::extract_partial_scores, driver.cc:411-446).  Under a
        ``group``, this rank's block of ``ds`` only (a ``BlockDataset``):
        each rank extracts its own rows (a 2-D mesh's data axis's).  """
        group = data_group(group)
        if group is not None:
            ds = rank_block(ds, group.world_size, group.rank)
        P = algo.partial_scores_dataset(ds, device=device)
        return dataclasses.replace(ds, features=np.ascontiguousarray(P, np.float32),
                                   name=f"partial:{ds.name}")

    def optimize(self, algo, train, valid=None, metric=None, verbose: bool = True,
                 ptrain=None, pvalid=None, mesh=None, device=None) -> dict:
        """Prune and re-weight ``algo`` on ``device`` (the CUDA card by
        default, or "cpu").  ``ptrain``/``pvalid`` may supply precomputed
        per-tree score datasets (the driver's --train-partial /
        --valid-partial, driver.cc:270-298).  With ``mesh``, a
        ``parallel.DataGroup``, this rank works on its block of the folds
        (of ``ptrain`` / ``pvalid`` too, unless they are ``BlockDataset``
        blocks already) on the group's device, and every rank prunes the
        same set.  Under a ``parallel.mesh.Mesh2D`` it works over the data
        axis (the per-tree scores have no feature axis; JAX's ``Fold`` takes
        the mesh's first axis): the ranks of a query block run the same
        pruning.  Returns ``info``: metrics and tree counts before and after,
        the pruned slots, and the seconds of the extraction, the selection
        and each line search."""
        import time

        refuse_mesh(mesh, "Cleaver.optimize(mesh=...)")
        verbose = verbose and (mesh is None or mesh.rank == 0)
        mesh = data_group(mesh)
        device = mesh.device if mesh is not None else resolve_device(device)
        metric = metric or algo.default_metric()
        info: dict = {}
        t0 = time.time()
        if ptrain is None:
            ptrain = self.partial_dataset(algo, train, device, mesh)
        if pvalid is None and valid is not None:
            pvalid = self.partial_dataset(algo, valid, device, mesh)
        info["extract_seconds"] = time.time() - t0
        T = ptrain.num_features
        ev = _PartialEval(metric, ptrain, device, mesh)
        ev_valid = (_PartialEval(metric, pvalid, device, mesh) if pvalid is not None
                    else None)

        window = self.last_estimators_to_optimize or T
        opt_last_only = self.last_estimators_to_optimize > 0
        if self.pruning_rate < 1:
            to_prune = int(round(self.pruning_rate * window))
        else:
            to_prune = int(self.pruning_rate)
            if to_prune >= window:
                raise ValueError("pruning rate too high (cleaver.cc:188-193)")

        if self.weights_ is None:
            weights = np.asarray(algo.get_weights(), np.float64)
        else:
            if len(self.weights_) != T:
                raise ValueError("preset Cleaver weights size mismatch")
            weights = self.weights_.copy()
        starting_weights = weights.copy()

        m_before = ev.metric_of_weights(weights)
        info.update(metric_before=m_before, num_trees_before=T)
        if ev_valid is not None:
            info["metric_before_valid"] = ev_valid.metric_of_weights(weights)
        if verbose:
            print(f"# CLEAVER[{self.pruning_method}] trees={T} prune={to_prune}")
            print(f"# before: train {m_before:.4f}")

        # -- optional pre-pruning line search --------------------------------
        if self.line_search_pre_pruning() and to_prune > 0 and self.line_search:
            ls = self.line_search
            if opt_last_only:
                ls.train_only_last = window
            lw = None if ls.best_weights is None else np.asarray(ls.get_weights())
            if lw is None or lw.size == 0:
                # no pre-learned weights (also an XML-loaded LS whose
                # <ensemble> was empty): run the line search
                ls.update_weights(weights)
                t1 = time.time()
                ls.learn(ptrain, pvalid, metric, verbose=False, device=device, mesh=mesh)
                info["pre_ls_seconds"] = time.time() - t1
                weights = ls.get_weights().copy()
            else:
                # reuse pre-learned LS weights, rescaled to the algorithm's
                # magnitude (cleaver.cc:265-291; a size mismatch exits there)
                if lw.size != weights.size:
                    raise ValueError(
                        f"--line-search-model: {lw.size} weights but the "
                        f"ensemble has {weights.size} trees "
                        "(cleaver.cc:268-273 rejects the same mismatch)"
                    )
                scale = np.mean(lw) / max(np.mean(starting_weights), 1e-12)
                weights = lw / max(scale, 1e-12)

        # -- strategy selection ----------------------------------------------
        t1 = time.time()
        pruned = self._pruning(weights, ev, window, to_prune)
        info["prune_seconds"] = time.time() - t1
        info["pruned"] = sorted(int(i) for i in pruned)

        # -- pruned zeroed, survivors keep their pre-LS weights ----------------
        weights = starting_weights.copy()
        weights[list(pruned)] = 0.0

        # -- post-pruning line search on the filtered matrix -----------------
        if self.line_search is not None:
            keep = np.asarray([f for f in range(T) if f not in pruned], dtype=np.int64)
            ls = self.line_search
            ls.update_weights(weights[keep])
            if opt_last_only:
                ls.train_only_last = window - to_prune
            ftrain = _filter_columns(ptrain, keep)
            fvalid = _filter_columns(pvalid, keep) if pvalid is not None else None
            t1 = time.time()
            ls_hist = ls.learn(ftrain, fvalid, metric, verbose=False, device=device,
                               mesh=mesh)
            info["post_ls_seconds"] = time.time() - t1
            info["post_ls_iteration_seconds"] = ls_hist["iteration_seconds"]
            weights[keep] = ls.get_weights()

        # -- write back (drops zero-weight trees, ensemble.cc:149-192) ------
        if self.update_model:
            algo.update_weights(weights)
        self.weights_ = weights

        m_after = ev.metric_of_weights(weights)
        self.metric_on_training_ = m_after
        if ev_valid is not None:
            self.metric_on_validation_ = ev_valid.metric_of_weights(weights)
            info["metric_after_valid"] = self.metric_on_validation_
        info["metric_after"] = m_after
        info["num_trees_after"] = int(np.sum(weights != 0))
        if verbose:
            print(f"# after: train {m_after:.4f} ({info['num_trees_after']} trees)")
        return info

    # -- strategies --------------------------------------------------------

    def _pruning(self, weights, ev: _PartialEval, window, k) -> set:
        T = ev.num_trees
        start = T - window
        rng = np.random.default_rng(self.seed)
        method = self.pruning_method

        if method == "RANDOM":
            return set(start + rng.choice(window, size=k, replace=False))

        if method == "LAST":
            return set(range(T - k, T))

        if method == "SKIP":
            # keep every (window / (window - k))-th (skip_pruning.cc:47-59)
            select = window - k
            step = window / select
            kept = {int(np.ceil(step * i + start)) for i in range(select)}
            return {f for f in range(start, T) if f not in kept}

        if method == "LOW_WEIGHTS":
            idx = np.argsort(weights[start:T], kind="stable")[:k]
            return set(start + idx)

        base = ev.base(weights)

        if method == "QUALITY_LOSS":
            ms = ev.drop_one_metrics(base, weights, start)
            # prune the k whose removal leaves the highest metric
            idx = np.argsort(-ms, kind="stable")[:k]
            return set(start + idx)

        if method == "QUALITY_LOSS_ADV":
            # greedy: the removal metrics again after each pick, with the
            # picked trees' contribution taken out of the base
            pruned: set = set()
            for _ in range(k):
                ms = ev.drop_one_metrics(base, weights, start)
                for f in pruned:
                    ms[f - start] = -np.inf
                best = start + int(np.argmax(ms))
                pruned.add(best)
                base = ev.apply_drop(base, weights, best)
            return pruned

        if method == "SCORE_LOSS":
            # sum of the score-normalised per-tree contribution, the
            # smallest pruned (score_loss_pruning.cc:58-77)
            fs = ev.score_loss_sums(base, weights)[start:T]
            idx = np.argsort(fs, kind="stable")[:k]
            return set(start + idx)

        if method == "RANDOM_ADV":
            # the best of 100 random prune sets by the resulting metric
            sets = [start + rng.choice(window, size=k, replace=False) for _ in range(100)]
            masks = np.zeros((100, T), np.float32)
            for i, s in enumerate(sets):
                masks[i, s] = 1.0
            ms = ev.mask_metrics(base, weights, masks)
            best = int(np.argmax(ms))
            return set(int(x) for x in sets[best])

        raise AssertionError(method)

    # -- optimizer-model XML (Cleaver::get_xml_model, cleaver.cc:111-150;
    #    Optimization::save/load, optimization.cc:36-80) -----------------

    def _to_xml(self):
        import xml.etree.ElementTree as ET

        from quickrank_tpu_torch.io.xml_model import _fmt_f

        root = ET.Element("optimizer")
        info = ET.SubElement(root, "info")
        ET.SubElement(info, "opt-algo").text = self.NAME
        ET.SubElement(info, "opt-method").text = self.pruning_method
        ET.SubElement(info, "pruning-rate").text = str(self.pruning_rate)
        if self.line_search is not None:
            # the line search's hyperparameters as <line-search>: the
            # reference grafts the LS model's <info> under that tag
            # (cleaver.cc:126-135)
            ls_info = self.line_search._info_xml(ET.Element("ranker"))
            ls_info.tag = "line-search"
            root.append(ls_info)
        ens = ET.SubElement(root, "ensemble")
        if self.weights_ is not None:
            for i, w in enumerate(self.weights_):
                t = ET.SubElement(ens, "tree")
                ET.SubElement(t, "index").text = str(i + 1)
                ET.SubElement(t, "weight").text = _fmt_f(w)
        return root

    def save(self, path: str) -> None:
        import xml.etree.ElementTree as ET

        tree = ET.ElementTree(self._to_xml())
        ET.indent(tree, space="\t")
        with open(path, "wb") as f:
            tree.write(f)

    @classmethod
    def _from_xml(cls, root) -> "Cleaver":
        info = root.find("info")

        def get(tag, cast, default):
            el = info.find(tag)
            return cast(el.text) if el is not None and el.text else default

        ls_el = root.find("line-search")
        ls = LineSearch(**LineSearch.info_kwargs(ls_el)) if ls_el is not None else None
        out = cls(pruning_method=get("opt-method", str, "QUALITY_LOSS"),
                  pruning_rate=get("pruning-rate", float, 0.5), line_search=ls)
        # the full model: per-tree weights under <ensemble> (cleaver.cc:88-107)
        trees = root.findall("ensemble/tree")
        if trees:
            size = max(int(t.find("index").text) for t in trees)
            w = np.zeros(size, np.float64)
            for t in trees:
                w[int(t.find("index").text) - 1] = float(t.find("weight").text)
            out.weights_ = w
        return out

    @staticmethod
    def load(path: str) -> "Cleaver":
        """Optimization::load_model_from_file (optimization.cc:50-80)."""
        import xml.etree.ElementTree as ET

        root = ET.parse(path).getroot()
        if root.tag != "optimizer":
            raise ValueError(f"{path}: not an optimizer model")
        name = root.find("info/opt-algo").text.strip()
        if name not in ("CLEAVER", "EPRUNING"):
            raise ValueError(f"unknown optimizer type {name!r}")
        return Cleaver._from_xml(root)

    def apply_weights(self, algo) -> None:
        """Apply a loaded optimizer's weights to a ranker without searching
        again (the testing path of a saved --opt-model)."""
        if self.weights_ is None:
            raise RuntimeError("Cleaver: no stored weights to apply")
        algo.update_weights(self.weights_)


def _filter_columns(ds: Dataset, keep: np.ndarray) -> Dataset:
    """The pruned columns dropped (Cleaver::filter_dataset, cleaver.cc:448-481);
    a ``BlockDataset`` stays one."""
    return dataclasses.replace(ds, features=np.ascontiguousarray(ds.features[:, keep]),
                               name=f"filtered:{ds.name}")
