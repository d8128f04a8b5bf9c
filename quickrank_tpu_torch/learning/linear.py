"""Linear rankers: CoordinateAscent and LineSearch (counterpart of
quickrank_tpu/learning/linear.py, after src/learning/linear/
coordinate_ascent.cc:116-248 and line_search.cc:153-419).

Both search weight vectors for ``score = w . x`` by evaluating a grid of
candidate weights.  A feature step builds the ``[P+1, N]`` candidate score
matrix on the device and evaluates the metric of every row in one batched
pass (:meth:`Fold.metrics`); the host keeps the weight vector, picks the
best point and decides.  The JAX package computes the batch as a ``vmap``
of its metric (plain XLA, no Pallas kernel), so the port uses plain torch.

Semantics kept:
  * CA: cyclic per-feature window search, candidates < 0 discarded, only a
    strict improvement accepted, L1 renormalisation after each accepted
    update (coordinate_ascent.cc:166-199), the window shrinking per epoch;
  * LS: step 1 searches each feature from ``w_prev`` against the global
    best metric, step 2 jointly along ``w - w_prev`` (line_search.cc:
    249-344), the adaptive reduction factor (:349-358), ``train_only_last``
    (:236-238), weight import and export for Cleaver;
  * both: early stop after ``max_failed_vali`` epochs without a better
    validation metric, the best weights kept.

Last bits.  The JAX package's jitted steps are rewritten by XLA on the CPU,
and the port repeats the rewritten arithmetic: ``2 * window / P`` is
``window * f32(2/P)``, a division by the constant ``P`` a multiplication by
``f32(1/P)``, and ``presum = full - w_i * col``, ``presum + pts * col``,
``base + p * dscore`` and ``w_prev + d * s`` are each one fused
multiply-add (``ops/scoring.py::fma_f32``), and ``X @ w`` sums in XLA's
order (``ops/scoring.py::matvec_f32``), on the card too.  So given the same
weights the candidate matrices are bitwise JAX's; the metrics are not (the
per-query sums, ``log2`` and the mean over queries go their own way), and
an argmax over an NDCG plateau can turn such a last bit into another point:
the tests hold the per-step metrics within 1e-6 and whole runs to a quality
band.

Query-sharded (``learn(mesh=group)``, a ``parallel.DataGroup``; JAX
linear.py:155-173, 1-D only): each rank holds its block of the queries in
its :class:`Fold`, builds its rows of every candidate matrix, and a batch's
per-query metrics cross ranks in one gather (:meth:`Fold.metrics`); the
host decisions read only those metrics, so every rank keeps one rank's
weights, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import BlockDataset, Dataset, rank_block, shard_and_pad
from quickrank_tpu_torch.learning.base import LTRAlgorithm, resolve_device
from quickrank_tpu_torch.learning.mart import refuse_mesh
from quickrank_tpu_torch.metrics.metrics import Metric
from quickrank_tpu_torch.ops.histogram import tree_sum
from quickrank_tpu_torch.ops.kernel_query_sum import pairwise_sum
from quickrank_tpu_torch.ops.scoring import fma_f32, matvec_f32
from quickrank_tpu_torch.parallel.mesh import BlockOrder, DataGroup, data_group

NEG_INF = float("-inf")
#: JAX's refusal of a 2-D mesh (linear.py:170-173), with its reason (PARITY.md
#: "known exclusions")
ONE_D = ("linear rankers support 1-D (data) meshes only: coordinate descent "
         "iterates the features one after another by design, so sharding the "
         "feature axis has no parallel win (PARITY.md known exclusions)")

#: device bytes one chunk of a candidate batch may take in :meth:`Fold.metrics`
CANDIDATE_BATCH_BYTES = 2 << 30
#: bytes a padded (query, slot) cell of one candidate takes there: the
#: gathered scores, labels and mask, the sort's keys, values and int64
#: order, the sorted labels, gains and discounts, and the ideal sort
_CELL_BYTES = 96


class Fold:
    """A dataset laid out for candidate searches on one device: the padded
    float32 feature matrix (padding rows zero), the per-query view, and the
    metric of many score vectors at once.

    Under a query-sharded ``group`` the fold is this rank's block (of
    ``ds``, or ``ds`` itself when it is a ``BlockDataset``), and every
    reduction over queries gathers the ranks' per-query values in global
    query order first (``parallel.mesh.BlockOrder``), so each rank computes
    the value one rank computes over all the queries, bit for bit.

    ``batch_bytes`` bounds the device memory of one chunk of
    :meth:`metrics`; the results do not depend on it."""

    def __init__(self, ds: Dataset, device, group: Optional[DataGroup] = None):
        device = torch.device(device)
        if group is None:
            padded = shard_and_pad(ds)
        else:
            if not isinstance(ds, BlockDataset):
                ds = rank_block(ds, group.world_size, group.rank)
            padded = shard_and_pad(ds, force_dims=ds.dims)
        to = lambda t: t.to(device)  # noqa: E731
        self.device = device
        self.num_features = ds.num_features
        self.X = to(torch.from_numpy(padded.features))
        self.pad_index = to(padded.pad_index)
        self.slot_mask = to(padded.slot_mask)
        self.labels2d = torch.where(self.slot_mask, to(padded.labels)[self.pad_index], 0.0)
        self.nvalid = to(padded.nvalid)
        self.query_mask = to(padded.query_mask)
        self.queries = BlockOrder.build(group, self.nvalid) if group is not None else None
        #: real queries and docs of the whole fold (every rank's)
        self.num_queries = (self.queries.count if group is not None
                            else int(padded.query_mask.sum()))
        self.num_docs = (self.queries.total if group is not None
                         else int(padded.doc_mask.sum()))
        self.batch_bytes = CANDIDATE_BATCH_BYTES

    def column(self, f: int) -> torch.Tensor:
        """Feature ``f`` of every padded row, float32 ``[N]``."""
        return self.X[:, f].contiguous()

    def dot(self, w) -> torch.Tensor:
        """``X @ w`` float32 ``[N]`` in XLA's order (``matvec_f32``)."""
        return matvec_f32(self.X, torch.from_numpy(np.asarray(w, np.float32)).to(self.device))

    def batch_size(self) -> int:
        """Candidates one chunk of :meth:`metrics` evaluates at once, from the
        whole fold's query count (so every rank of a group, and one rank,
        chunk alike)."""
        D = self.slot_mask.shape[1]
        return max(1, self.batch_bytes // max(1, self.num_queries * D * _CELL_BYTES))

    def real_queries(self, x: torch.Tensor) -> torch.Tensor:
        """Per-query values ``[..., Q]`` of this fold to ``[..., Q_real]``:
        every real query of the whole fold, in global order (one gather
        under a group)."""
        if self.queries is not None:
            return self.queries.gather(x)
        return x[..., self.query_mask]

    def metrics(self, metric: Metric, cands: torch.Tensor) -> torch.Tensor:
        """The dataset-level ``metric`` of each row of ``cands`` (float32
        ``[C, N]`` scores in padded order): float32 ``[C]``.  Per-query
        values come from ``metric.evaluate_per_query`` on the rows of a
        chunk stacked along the query axis; then every row's values over
        the real queries (:meth:`real_queries`, one gather for the batch)
        are summed in float64 and rounded once, so a row's value depends
        neither on the chunk it was evaluated in nor on the ranks."""
        Q, D = self.slot_mask.shape
        n = self.batch_size()
        pq = []
        for c0 in range(0, cands.shape[0], n):
            part = cands[c0:c0 + n]
            c = part.shape[0]
            sm = self.slot_mask.repeat(c, 1)
            s = torch.where(sm, part[:, self.pad_index].reshape(c * Q, D), 0.0)
            pq.append(metric.evaluate_per_query(s, self.labels2d.repeat(c, 1), sm,
                                                self.nvalid.repeat(c)).reshape(c, Q))
        if not pq:
            return torch.zeros(0, dtype=torch.float32, device=self.device)
        real = self.real_queries(torch.cat(pq))
        ones = torch.ones(real.shape[-1], dtype=torch.bool, device=self.device)
        _, den = metric.aggregate(real[0], ones, torch.tensor(self.num_docs,
                                                              device=self.device))
        return metric.finalize(real.double().sum(-1), den.double()).float()

    def metric(self, metric: Metric, scores: torch.Tensor) -> float:
        return float(self.metrics(metric, scores[None])[0])

    def doc_sums(self, x: torch.Tensor) -> torch.Tensor:
        """Per column of ``x [N, c]`` (per-doc values, zero on pad rows), the
        sum over the real docs of the whole fold: each query's docs, then
        the real queries in global order (:meth:`real_queries`), each by the
        pairwise tree of ``ops/kernel_query_sum.py::pairwise_sum``, whose
        order depends on the lengths only.  ``[c]``, in ``x``'s dtype."""
        per_doc = torch.where(self.slot_mask[..., None], x[self.pad_index], 0)
        per_query = pairwise_sum(per_doc, 1)
        return pairwise_sum(self.real_queries(per_query.T), -1)


def grid_points(center: np.float32, window: np.float32, num_points: int) -> np.ndarray:
    """The ``num_points + 1`` candidate weights of a window search, float32:
    ``center - window + step * i`` with ``step = 2 * window / num_points``,
    rounded as XLA evaluates the JAX expression (the division by the
    constant becomes a product with ``f32(2 / num_points)``)."""
    f32 = np.float32
    step = f32(window) * (f32(2.0) * (f32(1.0) / f32(num_points)))
    return (f32(center) - f32(window)) + step * np.arange(num_points + 1, dtype=f32)


def feature_candidates(full: torch.Tensor, col: torch.Tensor, wi: np.float32,
                       pts: np.ndarray) -> torch.Tensor:
    """Candidate scores float32 ``[P+1, N]`` for feature weight ``wi``
    moved to each of ``pts``: ``presum + pts * col`` with ``presum = full -
    wi * col``, both fused as XLA fuses them."""
    dev = full.device
    presum = fma_f32(torch.tensor(-np.float32(wi), device=dev), col, full)
    p = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(dev)
    return fma_f32(p[:, None], col[None, :], presum[None, :])


def joint_candidates(base: torch.Tensor, dscore: torch.Tensor, num_points: int) -> torch.Tensor:
    """LineSearch's step-2 candidate scores float32 ``[P+1, N]``: ``base +
    p * dscore`` for ``p = 0..P``, fused as XLA fuses it."""
    p = torch.arange(num_points + 1, dtype=torch.float32, device=base.device)
    return fma_f32(p[:, None], dscore[None, :], base[None, :])


def joint_point(w: np.ndarray, w_prev: np.ndarray, b: int, num_points: int) -> np.ndarray:
    """Step 2's weights at grid point ``b``: ``w_prev + (w - w_prev) / P *
    b``, which XLA evaluates as ``fma(w - w_prev, f32(b * f32(1/P)),
    w_prev)``."""
    s = np.float32(b) * (np.float32(1.0) / np.float32(num_points))
    return fma_f32(torch.from_numpy(w - w_prev), torch.tensor(s),
                   torch.from_numpy(w_prev)).numpy()


class _LinearRanker(LTRAlgorithm):
    def __init__(self, num_points: int = 21, window_size: float = 10.0,
                 reduction_factor: float = 0.95, max_iterations: int = 100,
                 max_failed_vali: int = 20):
        """Defaults mirror quicklearn's CA/LS group (src/quicklearn.cc:136-141)."""
        if int(num_points) < 2:
            # shared guard for both rankers: CA divides its step by
            # num_points and LineSearch by the evened count, so a 0/1-point
            # grid gives inf/NaN candidates, and a 1-point search means
            # nothing anyway
            raise ValueError(
                f"num_points={num_points} too small — at least 2 grid "
                "points are required (reference default 21)"
            )
        self.num_points = int(num_points)
        self.window_size = float(window_size)
        self.reduction_factor = float(reduction_factor)
        self.max_iterations = int(max_iterations)
        self.max_failed_vali = int(max_failed_vali)
        self.best_weights: Optional[np.ndarray] = None
        self.history: dict = {}

    def _require_weights(self) -> np.ndarray:
        if self.best_weights is None:
            raise RuntimeError(f"{self.NAME}: no trained model")
        return self.best_weights

    def scorer_path(self) -> str:
        return "linear"

    def device_scorer(self, ds: Dataset, device=None):
        """(fn, features on ``device``): ``fn`` maps the uploaded float64
        features to ``X @ w`` in float64, as the JAX package scores a linear
        model in numpy float64 (linear.py:123-126)."""
        device = resolve_device(device)
        w = torch.from_numpy(np.asarray(self._require_weights(), np.float64)).to(device)
        X = torch.from_numpy(np.ascontiguousarray(ds.features)).to(device).double()
        return (lambda x: x @ w), X

    def score_dataset(self, ds: Dataset, device=None) -> np.ndarray:
        """float64 scores per doc in dataset order."""
        fn, X = self.device_scorer(ds, device)
        return fn(X).cpu().numpy()

    def get_weights(self) -> np.ndarray:
        return np.asarray(self.best_weights)

    def update_weights(self, weights: np.ndarray) -> None:
        """Import a weight vector (LS: also its length, line_search.cc:429-443)."""
        self.best_weights = np.asarray(weights, np.float64).copy()

    def reset_weights(self) -> None:
        self.best_weights = None

    def import_model_state(self, other) -> None:
        """Adopt a loaded linear model's weights for a resume (the import
        path Cleaver uses, line_search.cc:429-443)."""
        if not isinstance(other, _LinearRanker) or other.best_weights is None:
            raise ValueError(
                f"restart-train: {self.NAME} cannot import model state from "
                f"{other.NAME}"
            )
        self.best_weights = np.asarray(other.best_weights, np.float64).copy()

    def _info_xml(self, root):
        import xml.etree.ElementTree as ET

        info = ET.SubElement(root, "info")
        ET.SubElement(info, "type").text = self.NAME
        ET.SubElement(info, "num-samples").text = str(self.num_points)
        ET.SubElement(info, "window-size").text = str(self.window_size)
        ET.SubElement(info, "reduction-factor").text = str(self.reduction_factor)
        ET.SubElement(info, "max-iterations").text = str(self.max_iterations)
        ET.SubElement(info, "max-failed-vali").text = str(self.max_failed_vali)
        return info

    @staticmethod
    def _kwargs_from_info(info) -> dict:
        def g(tag, cast, default):
            el = info.find(tag)
            return cast(el.text) if el is not None else default

        return dict(
            num_points=g("num-samples", int, 21),
            window_size=g("window-size", float, 10.0),
            reduction_factor=g("reduction-factor", float, 0.95),
            max_iterations=g("max-iterations", int, 100),
            max_failed_vali=g("max-failed-vali", int, 20),
        )

    def _folds(self, train, valid, device, mesh):
        """The train and valid folds on ``device``, or this rank's blocks on
        the group's device under ``mesh``."""
        refuse_mesh(mesh, one_d=ONE_D)
        mesh = data_group(mesh)
        device = mesh.device if mesh is not None else resolve_device(device)
        return (Fold(train, device, mesh),
                Fold(valid, device, mesh) if valid is not None else None)


class CoordinateAscent(_LinearRanker):
    NAME = "COORDASC"

    def feature_step(self, fold: Fold, metric: Metric, w: np.ndarray, i: int,
                     window: np.float32, base=None):
        """One feature step of an epoch (coordinate_ascent.cc:149-199):
        ``(w', pts, ms, base)`` with ``ms`` the float32 metrics of the
        candidate points ``pts`` (-inf where a point is negative) and
        ``base = (X @ w, current)``, ``current`` the metric of ``w``.  ``w``
        (float32) is not modified; ``w'`` is ``w`` itself when no point is
        accepted, and the next step may then pass ``base`` back in."""
        if base is None:
            full = fold.dot(w)
            base = (full, np.float32(fold.metric(metric, full)))
        full, current = base
        pts = grid_points(w[i], window, self.num_points)
        cands = feature_candidates(full, fold.column(i), w[i], pts)
        ms = fold.metrics(metric, cands).cpu().numpy()
        ms = np.where(pts >= 0, ms, np.float32(NEG_INF))
        b = int(np.argmax(ms))
        if not ms[b] > current:
            return w, pts, ms, base
        w = w.copy()
        w[i] = pts[b]
        return w / tree_sum(torch.from_numpy(w)).numpy(), pts, ms, base

    def learn(self, train: Dataset, valid: Optional[Dataset] = None,
              metric: Optional[Metric] = None, verbose: bool = True, device=None,
              mesh=None) -> dict:
        """Train on ``device`` (the CUDA card by default, or "cpu"), or on
        this rank's block under ``mesh`` (a ``parallel.DataGroup``; every
        rank returns the same weights); returns ``{"train": [...],
        "valid": [...], "epoch_seconds": [...]}``."""
        import time

        metric = metric or self.default_metric()
        fold, vfold = self._folds(train, valid, device, mesh)
        verbose = verbose and (mesh is None or mesh.rank == 0)
        F = train.num_features
        # the window is normalised by the feature count (coordinate_ascent.cc:123)
        window = self.window_size / F
        w = np.full((F,), np.float32(1.0 / F), np.float32)
        best_w = w.copy()
        best_va, fails = -np.inf, 0
        hist_tr, hist_va, seconds = [], [], []
        if verbose:
            print(f"# {self.NAME}: window={self.window_size} pts={self.num_points}")
            print("# iter. training validation")
        for b in range(self.max_iterations):
            t0 = time.time()
            base = None
            for i in range(F):
                # X @ w and its metric are computed again only when w moved
                w_new, _, _, base = self.feature_step(fold, metric, w, i,
                                                      np.float32(window), base)
                base, w = (base if w_new is w else None), w_new
            m_tr = fold.metric(metric, fold.dot(w))
            seconds.append(time.time() - t0)
            hist_tr.append(m_tr)
            if vfold is not None:
                m_va = vfold.metric(metric, vfold.dot(w))
                hist_va.append(m_va)
                improved = m_va > best_va
                if improved:
                    best_va, fails, best_w = m_va, 0, w.copy()
                else:
                    fails += 1
                if verbose:
                    print(f"# {b + 1:5d} {m_tr:.6f} {m_va:.6f}{' *' if improved else ''}")
                if fails >= self.max_failed_vali:
                    break
            elif verbose:
                print(f"# {b + 1:5d} {m_tr:.6f}")
            window *= self.reduction_factor
        if vfold is None:
            best_w = w
        self.best_weights = best_w.astype(np.float64)
        self.history = {"train": hist_tr, "valid": hist_va, "epoch_seconds": seconds}
        return self.history

    # -- XML (coordinate_ascent.cc:270-302) ---------------------------------

    def _to_xml(self):
        import xml.etree.ElementTree as ET

        root = ET.Element("ranker")
        self._info_xml(root)
        model = ET.SubElement(root, "model")
        for i, wv in enumerate(self._require_weights()):
            f = ET.SubElement(model, "feature")
            f.set("id", str(i + 1))
            f.set("weight", repr(float(wv)))
        return root

    @classmethod
    def _from_xml(cls, root):
        algo = cls(**cls._kwargs_from_info(root.find("info")))
        feats = root.findall("model/feature")
        w = np.zeros(len(feats), np.float64)
        for f in feats:
            w[int(f.get("id")) - 1] = float(f.get("weight"))
        algo.best_weights = w
        return algo


class LineSearch(_LinearRanker):
    NAME = "LINESEARCH"

    def __init__(self, num_points: int = 21, window_size: float = 10.0,
                 reduction_factor: float = 0.95, max_iterations: int = 100,
                 max_failed_vali: int = 20, adaptive: bool = False,
                 train_only_last: int = 0):
        super().__init__(num_points, window_size, reduction_factor, max_iterations,
                         max_failed_vali)
        self.adaptive = bool(adaptive)
        self.train_only_last = int(train_only_last)

    @property
    def grid_size(self) -> int:
        """The point count forced even so that the centre is on the grid
        (line_search.cc:162-165); at least 2 by the shared guard."""
        return self.num_points - (self.num_points % 2)

    def iteration(self, fold: Fold, metric: Metric, w: np.ndarray, w_prev: np.ndarray,
                  best_m: np.float32, window: np.float32, start: int = 0,
                  trace: Optional[list] = None):
        """One iteration (line_search.cc:249-344): step 1 moves each feature
        ``f >= start`` from ``w_prev`` where a point beats ``best_m``; step 2
        searches along ``w - w_prev``.  Returns ``(w, w_prev, best_m,
        gain)``, float32.  ``trace``, when given, receives ``(pts, ms)`` of
        every step-1 feature and then ``(pidx, ms2)`` of step 2."""
        P = self.grid_size
        f32 = np.float32
        full_prev = fold.dot(w_prev)
        w = w.copy()
        for f in range(start, fold.num_features):
            pts = grid_points(w_prev[f], window, P)
            cands = feature_candidates(full_prev, fold.column(f), w_prev[f], pts)
            ms = fold.metrics(metric, cands).cpu().numpy()
            ms = np.where(pts >= 0, ms, f32(NEG_INF))
            if trace is not None:
                trace.append((pts, ms))
            b = int(np.argmax(ms))
            if ms[b] > best_m:
                w[f] = pts[b]
        # step 2: the joint search along w - w_prev in P + 1 points; XLA
        # multiplies by f32(1/P) for the division by P
        dstep = (w - w_prev) * (f32(1.0) / f32(P))
        cands = joint_candidates(full_prev, fold.dot(dstep), P)
        ms2 = fold.metrics(metric, cands).cpu().numpy()
        if trace is not None:
            trace.append((np.arange(P + 1, dtype=f32), ms2))
        b2 = int(np.argmax(ms2))
        if np.any(dstep != 0) and ms2[b2] > best_m:
            w = joint_point(w, w_prev, b2, P)
            return w, w.copy(), f32(ms2[b2]), f32(ms2[b2] - best_m)
        return w, w_prev, f32(best_m), f32(0.0)

    def learn(self, train: Dataset, valid: Optional[Dataset] = None,
              metric: Optional[Metric] = None, verbose: bool = True, device=None,
              mesh=None) -> dict:
        """Train on ``device`` (the CUDA card by default, or "cpu"), or on
        this rank's block under ``mesh`` (a ``parallel.DataGroup``; every
        rank returns the same weights), from the imported weights when there
        are some, else from ones; returns ``{"train": [...], "valid":
        [...], "iteration_seconds": [...]}``."""
        import time

        metric = metric or self.default_metric()
        F = train.num_features
        if self.best_weights is not None and len(self.best_weights) != F:
            raise ValueError(
                f"LineSearch: imported weights size {len(self.best_weights)} "
                f"!= num_features {F} (line_search.cc:187-193)"
            )
        fold, vfold = self._folds(train, valid, device, mesh)
        verbose = verbose and (mesh is None or mesh.rank == 0)
        w0 = (np.ones(F) if self.best_weights is None else self.best_weights).astype(np.float32)
        start = max(0, F - self.train_only_last) if self.train_only_last else 0
        w, w_prev = w0.copy(), w0.copy()
        best_m = np.float32(fold.metric(metric, fold.dot(w)))
        best_w = w.astype(np.float64)
        best_va = vfold.metric(metric, vfold.dot(w)) if vfold is not None else -np.inf
        # window = mean weight * window factor (line_search.cc:232-236)
        window_start = float(np.mean(w0)) * self.window_size
        window = window_start
        fails = 0
        hist_tr, hist_va, seconds = [], [], []
        if verbose:
            print(f"# {self.NAME}: window={self.window_size} pts={self.grid_size}")
            print("# iter. training validation gain window")
        for it in range(self.max_iterations):
            t0 = time.time()
            w, w_prev, best_m, gain = self.iteration(fold, metric, w, w_prev, best_m,
                                                     np.float32(window), start)
            seconds.append(time.time() - t0)
            gain = float(gain)
            hist_tr.append(float(best_m))
            red = self.reduction_factor
            if self.adaptive:
                # metric-relative speed-up or slow-down (line_search.cc:349-358)
                max_gain = 0.005
                red = 1.0 + max(min((gain - max_gain) / max_gain, 1.0), -0.5)
            if vfold is not None:
                m_va = vfold.metric(metric, vfold.dot(w))
                hist_va.append(m_va)
                improved = m_va > best_va
                if improved:
                    best_va, fails, best_w = m_va, 0, w.astype(np.float64)
                else:
                    fails += 1
                if verbose:
                    print(f"# {it + 1:5d} {float(best_m):.6f} {m_va:.6f} {gain:.6f} "
                          f"{window:.5f}{' *' if improved else ''}")
                if fails >= self.max_failed_vali:
                    break
            elif verbose:
                print(f"# {it + 1:5d} {float(best_m):.6f} {gain:.6f} {window:.5f}")
            window *= red
            if self.adaptive and window < window_start / 10:
                break
        if vfold is None:
            best_w = w.astype(np.float64)
        self.best_weights = best_w
        self.history = {"train": hist_tr, "valid": hist_va, "iteration_seconds": seconds}
        return self.history

    # -- XML (line_search.cc:102-132) ---------------------------------------

    def _info_xml(self, root):
        import xml.etree.ElementTree as ET

        info = super()._info_xml(root)
        ET.SubElement(info, "adaptive").text = str(self.adaptive).lower()
        ET.SubElement(info, "train-only-last").text = str(self.train_only_last)
        return info

    def _to_xml(self):
        import xml.etree.ElementTree as ET

        root = ET.Element("ranker")
        self._info_xml(root)
        ens = ET.SubElement(root, "ensemble")
        for i, wv in enumerate(self._require_weights()):
            t = ET.SubElement(ens, "tree")
            ET.SubElement(t, "index").text = str(i + 1)
            ET.SubElement(t, "weight").text = repr(float(wv))
        return root

    @classmethod
    def info_kwargs(cls, info) -> dict:
        """Constructor arguments from an ``<info>`` (or Cleaver's
        ``<line-search>``) element."""
        el = info.find("adaptive")
        tol = info.find("train-only-last")
        return dict(
            cls._kwargs_from_info(info),
            adaptive=el.text.strip().lower() in ("1", "true") if el is not None else False,
            train_only_last=int(tol.text) if tol is not None else 0,
        )

    @classmethod
    def _from_xml(cls, root):
        algo = cls(**cls.info_kwargs(root.find("info")))
        trees = root.findall("ensemble/tree")
        w = np.zeros(len(trees), np.float64)
        for t in trees:
            w[int(t.find("index").text) - 1] = float(t.find("weight").text)
        algo.best_weights = w
        return algo
