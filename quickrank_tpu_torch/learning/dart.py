"""DART / X-DART, LambdaMART with per-iteration tree dropout (counterpart of
quickrank_tpu/learning/dart.py, after src/learning/forests/dart.cc).

The boosting core (lambda gradients, tree fit, rescoring, metric) runs on
the training device; the dropout bookkeeping (which trees to drop, weight
normalization on restore, permanent pruning) is host logic copied from the
JAX package draw for draw, driven by ``np.random.default_rng(seed)``:

  * sampling types (dart.cc:708-854): UNIFORM, TOP_FIFTY (shuffle of the
    first half), WEIGHTED / WEIGHTED_INV (roulette by weight), CONTR /
    CONTR_INV / WCONTR / WCONTR_INV (roulette by |score| contribution),
    TOP_WCONTR / LESS_WCONTR (extremal weighted contribution);
  * normalization types (dart.cc:856-1060): TREE, NONE, WEIGHTED, FOREST,
    TREE_ADAPTIVE, TREE_BOOST3, LINESEARCH (17 points over the new tree's
    weight, the first maximum), CONTR, WCONTR, LMART_ADAPTIVE;
  * adaptive dropout-count schedules (dart.cc:1095-1181): FIXED, PLUS1_DIV2,
    PLUSHALF_DIV2, PLUSONETHIRD_DIV2, PLUSHALF_RESET(+LB1_UB5/UB10/UBRD),
    capped at half the live model (integer division) and rounded half away
    from zero, as C's round();
  * X-DART (dart.cc:430-515): ``keep_drop`` removes the dropped set for good
    when fitting after dropout improves the reference metric (or with
    probability ``random_keep``); ``drop_on_best`` compares against the best
    metric so far; zero-weight trees are compacted whenever the best model
    improves, and a full rescore fights drift every >10 iterations after a
    cleanup (dart.cc:552-558).

The dropped-set delta.  The learner keeps the ensemble's bin-space
QuickScorer tables packed on the training device (``[capacity, S]``,
``trees/qs.py::pack_tables``), appends one row a tree
(``trees/qs.py::tree_to_qs_row``) and rebuilds them only on compaction and
warm start.  A dropped iteration gathers the dropped slots' rows, writes
their current weights into the rows' weight words (the stored words are
never read otherwise: the weights change every iteration) and scores the
train and valid bin rows (the u8 or u16 wire) through
``ops/kernel_qs.py::score_qs``: the QuickScorer
kernel on the card, its plain version on the CPU.  Its cost follows the
number of dropped trees, not the ensemble's size.  Against the JAX package
the delta differs only in the order of the sum (here a Kahan chain in drop
order), never in routing or leaf values.

Score updates of the form ``s + w * d`` are fused multiply-adds
(``ops/scoring.py::fma_f32``), as XLA contracts them on the CPU.

Query-sharded training (``learn(mesh=group)``, a ``parallel.DataGroup``;
JAX dart.py:165-258): every rank keeps the same drop table (trees, not
docs), the same host generator and the same weights, and runs the fit, the
deltas, the rescores and the metrics on its own block.  The trees go through
Mart's sharded growers; every metric (the line search's 16 points at once,
the keep and restore decisions) is :func:`~quickrank_tpu_torch.learning.mart.
reduce_queries` of the ranks' per-query values gathered in global order; a
new tree's contribution (the CONTR samplers' and normalizations' input) is
the mean |output| over the docs of every rank, gathered into global doc
order and summed as one rank sums them.  So every decision is one rank's,
bit for bit.  ``subsample`` is one draw shared by the ranks, as Mart's is.
Rank 0 alone prints and saves.

Under a 2-D data x feature mesh (``learn(mesh=...)`` a ``parallel.mesh.
Mesh2D``; JAX dart.py:166-209, :457-493) the train fold is this rank's
feature block, which the QuickScorer tables cannot score: the train-side
dropped-set delta and the periodic full rescore descend it with the owners'
node tests (``ops/scoring.py::delta_owned``, one all-reduce over the feature
axis a block of docs and slots, its memory bounded by a fixed number of
words) and sum in the same Kahan chain, so they are the kernel's bits.
The valid fold stays whole on the feature axis, and its deltas on the
kernel.  A warm start is refused, as in JAX.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

import torch.nn.functional as F

from quickrank_tpu_torch.data.dataset import DOC_ALIGN, Dataset
from quickrank_tpu_torch.learning.lambdamart import LambdaMart
from quickrank_tpu_torch.learning.mart import (
    TrainData,
    _copy_into,
    build_valid_traindata,
    eval_metric,
    per_query,
    rebin_ensemble,
    reduce_queries,
    refuse_mesh,
    rescore_binned,
)
from quickrank_tpu_torch.parallel.mesh import feature_sharded
from quickrank_tpu_torch.metrics.metrics import Metric
from quickrank_tpu_torch.ops.binning import scorer_rows
from quickrank_tpu_torch.ops.histogram import tree_sum
from quickrank_tpu_torch.ops.kernel_qs import partial_score_blocks, score_qs
from quickrank_tpu_torch.ops.scoring import delta_owned, fma_f32, tree_delta_binned
from quickrank_tpu_torch.trees.grow import leaf_outputs
from quickrank_tpu_torch.trees.qs import (
    ensemble_to_qs,
    pack_tables,
    qs_shape,
    table_from_packed,
    tree_to_qs_row,
)
from quickrank_tpu_torch.trees.structs import EnsembleTensors
from quickrank_tpu_torch.utils.profiling import span

SAMPLING_TYPES = (
    "UNIFORM", "WEIGHTED", "WEIGHTED_INV", "TOP_FIFTY", "CONTR", "CONTR_INV",
    "WCONTR", "WCONTR_INV", "TOP_WCONTR", "LESS_WCONTR",
)
NORMALIZATION_TYPES = (
    "TREE", "NONE", "WEIGHTED", "FOREST", "TREE_ADAPTIVE", "LINESEARCH",
    "TREE_BOOST3", "CONTR", "WCONTR", "LMART_ADAPTIVE",
)
#: the sampling and normalization types that read per-tree contributions
_CONTRIBUTION_TYPES = ("CONTR", "CONTR_INV", "WCONTR", "WCONTR_INV", "TOP_WCONTR",
                       "LESS_WCONTR")
#: JAX's refusal of a warm start under feature-axis sharding (dart.py:176-181)
WARM_START_2D = ("DART warm start (--restart-train) under feature-axis sharding is not "
                 "supported — drop --num-feat-shards (PARITY.md known exclusions)")
ADAPTIVE_TYPES = (
    "FIXED", "PLUS1_DIV2", "PLUSHALF_DIV2", "PLUSONETHIRD_DIV2",
    "PLUSHALF_RESET", "PLUSHALF_RESET_LB1_UB5", "PLUSHALF_RESET_LB1_UB10",
    "PLUSHALF_RESET_LB1_UBRD",
)

#: trees dropped by the iterations of ``Dart.learn``, and the iterations that
#: ended in a full rescore of the folds; a run that reports them sets them to
#: 0 first and reads them after (as ``trees/grow.py::HOST_SYNCS``)
DROPPED = 0
RESCORES = 0


class DropTable:
    """The ensemble's bin-space QuickScorer tables, packed, on the training
    device: row ``t`` is slot ``t``'s tree (dead rows score 0).  Trees are
    appended a row at a time; the weight words are stale by design, since
    :meth:`delta` and :meth:`partial` write the weights they are given."""

    def __init__(self, ens: EnsembleTensors, device):
        self.max_nodes = ens.max_nodes
        I, L, W = qs_shape(self.max_nodes)
        self.weight_word = I * W * 4 + L
        packed = pack_tables(ensemble_to_qs(ens, space="bin"))
        self.dead_row = pack_tables(ensemble_to_qs(
            EnsembleTensors.empty(1, self.max_nodes), space="bin"))[0].to(device)
        self.rows = packed.to(device)

    def append(self, slot: int, tree, weight: float) -> None:
        with span("qr.boost.readback"):
            host = dataclasses.replace(tree, **{f.name: getattr(tree, f.name).cpu()
                                                for f in dataclasses.fields(tree)})
        row = tree_to_qs_row(host, weight)
        with span("qr.boost.readback"):  # a pageable upload syncs the stream
            self.rows[slot] = row.to(self.rows.device)

    def compact(self, keep: np.ndarray) -> None:
        """Slots ``keep`` move to the head, in order; the rest die."""
        with span("qr.boost.readback"):
            idx = torch.from_numpy(keep).to(self.rows.device)
        head = self.rows.index_select(0, idx)
        self.rows[:] = self.dead_row
        self.rows[: len(keep)] = head

    def gathered(self, slots, weights: np.ndarray):
        """QSEnsemble of the rows ``slots`` in that order, their weight
        words set to ``weights``."""
        w = torch.from_numpy(np.ascontiguousarray(weights, np.float32)).view(torch.int32)
        with span("qr.boost.readback"):  # pageable uploads sync the stream
            idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.rows.device)
            w = w.to(self.rows.device)
        rows = self.rows.index_select(0, idx)
        rows[:, self.weight_word] = w
        return table_from_packed(rows, self.max_nodes)

    def delta(self, slots, weights: np.ndarray, features: torch.Tensor) -> torch.Tensor:
        """sum_i weights[i] * tree_{slots[i]}(doc), f32 [N], on ``features``'
        device: the kernel on the card, the plain scorer on the CPU."""
        return score_qs(features, self.gathered(slots, weights))

    def partial(self, num_trees: int, features: torch.Tensor):
        """Yields ``(t0, t1, cols)``: the unweighted per-tree scores f32
        ``[N, t1 - t0]`` of slots ``[t0, t1)`` of the first ``num_trees``,
        a block of trees at a time (the kernel's partial entry on the card)."""
        return partial_score_blocks(
            features, table_from_packed(self.rows[:num_trees], self.max_nodes))


def mean_over_docs(values: torch.Tensor, n_real: int, docs=None) -> torch.Tensor:
    """Each row of ``values [..., N]`` (zero on pad rows) summed over the doc
    axis in XLA's order (``ops/histogram.py::tree_sum``, as JAX sums it) and
    divided by the real doc count ``n_real``.  Under a group, ``docs`` (a
    ``parallel.mesh.BlockOrder`` of the docs) gathers every rank's real docs
    into global order, padded with zeros as one rank's layout pads them, so
    the mean is one rank's bit for bit."""
    if docs is not None:
        values = docs.gather(values)
        n = values.shape[-1]
        values = F.pad(values, (0, -(-(n + 1) // DOC_ALIGN) * DOC_ALIGN - n))
    return tree_sum(values) / np.float32(n_real)


class Dart(LambdaMart):
    NAME = "DART"

    def __init__(
        self,
        *args,
        sample_type: str = "UNIFORM",
        normalize_type: str = "TREE",
        adaptive_type: str = "FIXED",
        rate_drop: float = 0.1,
        skip_drop: float = 0.0,
        keep_drop: bool = False,
        best_on_train: bool = False,
        random_keep: float = 0.0,
        drop_on_best: bool = False,
        **kw,
    ):
        super().__init__(*args, **kw)
        self.sample_type = sample_type.upper()
        self.normalize_type = normalize_type.upper()
        self.adaptive_type = adaptive_type.upper()
        for val, known in (
            (self.sample_type, SAMPLING_TYPES),
            (self.normalize_type, NORMALIZATION_TYPES),
            (self.adaptive_type, ADAPTIVE_TYPES),
        ):
            if val not in known:
                raise ValueError(f"unknown DART option {val!r}; known: {known}")
        self.rate_drop = float(rate_drop)
        self.skip_drop = float(skip_drop)
        self.keep_drop = bool(keep_drop)
        self.best_on_train = bool(best_on_train)
        self.random_keep = float(random_keep)
        self.drop_on_best = bool(drop_on_best)

    # ------------------------------------------------------------------

    def _uses_contributions(self) -> bool:
        """Whether a sampler or a normalization reads the per-tree
        contributions (otherwise they are not computed, and stay 0)."""
        return (self.sample_type in _CONTRIBUTION_TYPES
                or self.normalize_type in _CONTRIBUTION_TYPES)

    def _fit(self, m: int, tr: TrainData, va: Optional[TrainData], scores_tr, cfg,
             md: int, docs=None):
        """Fit iteration ``m``'s tree on ``scores_tr``: (tree, train leaf
        values d_tr, valid leaf values d_va or None, contribution = mean
        |d_tr| over the real docs, :func:`mean_over_docs`; 0 when
        :meth:`_uses_contributions` is false)."""
        sd, group = tr.step, tr.group
        smask = self._sample_mask(tr, m, sd.doc_mask)
        with span("qr.boost.lambdas"):
            grad, w = self._gradients(sd, scores_tr, smask, full_mask=self.subsample == 1.0)
        w = w if self._newton else None
        with span("qr.grow"):
            tree, node, leaves_done = self._fit_and_assign(
                tr, grad, smask, cfg, self._generator(m, 1), weights=w)
            if not leaves_done:
                tree = leaf_outputs(tree, node, grad, smask, weights=w, group=group,
                                    num_docs=cfg.num_docs)
        d_tr = tree.leaf_value[node.long().clamp(min=0)]
        contrib = 0.0
        if self._uses_contributions():
            c = mean_over_docs(d_tr.abs() * sd.doc_mask, cfg.num_docs, docs)
            with span("qr.boost.readback"):
                contrib = float(c)
        with span("qr.boost.metrics"):
            d_va = tree_delta_binned(va.step.binned, tree, md) if va is not None else None
        return tree, d_tr, d_va, np.float32(contrib)

    @staticmethod
    def _contributions(table: DropTable, num_trees: int, features: torch.Tensor,
                       doc_mask: torch.Tensor, n_real: int, docs=None) -> list:
        """Mean |output| over the real docs of each of the first
        ``num_trees`` trees of ``table``, from their per-tree columns (the
        QuickScorer kernel's partial entry on the card), each summed in XLA's
        order as the JAX package's warm start sums it (``_contribs_j``;
        :func:`mean_over_docs`, gathered over a group's ranks by ``docs``)."""
        mask = doc_mask.float()[:, None]
        out = [mean_over_docs((cols.abs() * mask).T.contiguous(), n_real, docs)
               for _, _, cols in table.partial(num_trees, features)]
        if not out:
            return []
        with span("qr.boost.readback"):
            return [float(c) for c in torch.cat(out).cpu().numpy()]

    @staticmethod
    def _metrics(metric: Metric, tr: TrainData, va: Optional[TrainData], s_tr, s_va,
                 m_va: float = 0.0):
        """The metric of the train scores ``s_tr`` and of the valid scores
        ``s_va``, read back to the host (``m_va`` without a valid fold)."""
        with span("qr.boost.metrics"):
            d_tr = eval_metric(metric, tr.step, s_tr, tr.group)
            d_va = eval_metric(metric, va.step, s_va, tr.group) if va is not None else None
        with span("qr.boost.readback"):
            return float(d_tr), (float(d_va) if d_va is not None else m_va)

    def _linesearch(self, metric: Metric, tr: TrainData, s_tr, d_tr) -> np.float32:
        """The new tree's weight by a window search (dart.cc:977-1034): the
        positive points of 17 over [0, 2], the first maximum of the metric
        (the 16 metrics reduced at once, one gather under a group)."""
        pts = np.float32(2.0 / 16.0) * np.arange(17, dtype=np.float32)
        pq = torch.stack([per_query(metric, tr.step, fma_f32(torch.tensor(p), d_tr, s_tr))
                          for p in pts[1:]])
        ms = reduce_queries(metric, pq, tr.step, tr.group)
        with span("qr.boost.readback"):
            ms = ms.cpu().numpy()
        return pts[1 + int(np.argmax(ms))]

    def learn(self, train: Dataset, valid: Optional[Dataset] = None,
              metric: Optional[Metric] = None, verbose: bool = True, device=None,
              mesh=None, warm_start: bool = False, partial_save: int = 0,
              output_basename: str = "") -> dict:
        """Train on ``device`` (the CUDA card by default, or "cpu").
        ``warm_start`` resumes from the current ensemble after a full
        rescore and a rebuild of the per-tree contributions; ``partial_save``
        writes ``<output_basename>.T<k>.xml`` snapshots (the Mart family's
        --partial / --restart-train applied to the DART loop).  Returns the
        history dict: per-iteration train and valid metric, best iteration,
        times, per iteration the dropped slots (``dropped``) and the ms
        of their delta (``delta_ms``: CUDA events on the card, the host
        clock on the CPU), and the iterations that ended in a full rescore
        of the folds (``rescored``).  With ``mesh``, a ``parallel.DataGroup``, this
        rank trains on its block of ``train`` (or on ``train``, this
        process's ``TrainData``) on the group's device, and every rank
        returns the same model; a ``parallel.mesh.Mesh2D`` also shards the
        feature axis (no warm start)."""
        global DROPPED, RESCORES
        refuse_mesh(mesh)
        if feature_sharded(mesh) and warm_start:
            raise NotImplementedError(WARM_START_2D)
        self._refuse_2d(mesh, False)
        metric = metric or self.default_metric()
        t0 = time.perf_counter()
        with span("qr.learn.init"):
            tr = self._train_data(train, device, mesh)
            device = tr.step.binned.device
            group = tr.group
            lead = group is None or group.rank == 0
            verbose = verbose and lead
            va = build_valid_traindata(tr, valid, self.nthresholds, device)
            cfg = self._grow_config(tr.num_bins, tr.num_real_features, tr.num_docs)
            self._train_metric = metric
            md = self._descend_depth()
            rng = np.random.default_rng(self.seed)
            n_real = tr.num_docs
            # under a group, where every rank's real docs sit in global order (the
            # contributions' sum); a gather of the doc mask, once
            docs = (tr.step.doc_order()
                    if group is not None and self._uses_contributions() else None)
            on_card = device.type == "cuda"

            feats_tr = scorer_rows(tr.step.binned)
            feats_va = scorer_rows(va.step.binned) if va is not None else None

            cap = self.ntrees + max(16, self.ntrees // 4)
            nt = self.normalize_type
            s_ = np.float32(self.shrinkage)
            ens = EnsembleTensors.empty(cap, cfg.max_nodes, device)
            # the host weights are the master copy; the device's follow them
            w_host = np.zeros(cap, np.float32)
            T_host = 0
            scores_tr = torch.zeros(tr.padded.num_docs_padded, dtype=torch.float32,
                                    device=device)
            scores_va = (torch.zeros(va.padded.num_docs_padded, dtype=torch.float32,
                                     device=device) if va is not None else None)
            contributions: list = []
            m_tr = 0.0
            m_va = 0.0
            best_tr, best_va = -np.inf, -np.inf
            best_iter = -1
            best_size = 0
            best_weights = np.zeros(0, np.float32)
            dropped_before_cleaning = 0
            dropout_factor_hist = [0.0]
            perf_valid_hist = [0.0]
            last_global_rescore = 0
            rescored = []
            hist_tr, hist_va = [], []

            def sync_weights():
                with span("qr.boost.readback"):  # a pageable upload syncs the stream
                    ens.weight.copy_(torch.from_numpy(w_host))

            def train_delta(slots, weights):
                """The dropped trees' weighted sum on the train fold: the
                kernel, or over a feature block the owners' tests."""
                if tr.feat is None:
                    return table.delta(slots, weights, feats_tr)
                return delta_owned(tr.step.binned, ens, slots, weights, tr.feat, md)

            def train_rescore():
                """The full rescore of the train fold (every slot, the dead
                ones with weight 0, as ``rescore_binned``)."""
                if tr.feat is None:
                    return rescore_binned(ens, tr.step, md)
                w = np.zeros(ens.capacity, np.float32)
                with span("qr.boost.readback"):
                    w[:ens.num_trees] = ens.weight[:ens.num_trees].cpu().numpy()
                return delta_owned(tr.step.binned, ens, range(ens.capacity), w, tr.feat, md)

            iter_offset = 0
            warm = warm_start and self.ensemble is not None and self.ensemble.num_trees > 0
            if warm:
                src = rebin_ensemble(self.ensemble.live(), tr.thresholds, force=True)
                _copy_into(ens, src.to(device))
            table = DropTable(ens, device)
            if warm:
                T0 = ens.num_trees
                iter_offset = T0
                scores_tr = rescore_binned(ens, tr.step, md)
                m_tr = float(eval_metric(metric, tr.step, scores_tr, group))
                if va is not None:
                    scores_va = rescore_binned(ens, va.step, md)
                    m_va = float(eval_metric(metric, va.step, scores_va, group))
                # per-tree mean |output| drives the CONTR samplers: rebuilt for
                # the imported trees from their per-tree columns
                contributions = (self._contributions(table, T0, feats_tr, tr.step.doc_mask,
                                                     n_real, docs)
                                 if self._uses_contributions() else [0.0] * T0)
                best_tr = m_tr
                best_va = m_va if va is not None else -np.inf
                best_iter = 0
                best_size = T0
                T_host = T0
                w_host[:T0] = ens.weight[:T0].cpu().numpy()
                best_weights = w_host[:T0].copy()
        init_time = time.perf_counter() - t0
        if verbose:
            print(f"# {self.NAME}: {self!r}")
        t_train = time.perf_counter()
        iter_seconds, dropped_per_iter, dropped_sets, delta_events = [], [], [], []
        m = 0
        while T_host - dropped_before_cleaning < self.ntrees:
            m += 1
            if va is not None and self.esr and m > best_iter + self.esr:
                break
            t_iter = time.perf_counter()
            with span("qr.boost.iter"):
                if T_host >= cap:
                    # capacity guard: drop zero-weighted trees now, but keep the
                    # best snapshot's slots (the first best_size, trees being
                    # appended only) so that the final rollback stays valid
                    with span("qr.dart.compact"):
                        ens, contributions, w_host, T_host = self._compact_zero_weights(
                            ens, contributions, w_host, T_host, protect=max(best_size, 0),
                            table=table)
                    dropped_before_cleaning = int(np.sum(w_host[:T_host] == 0))
                    if T_host >= cap:
                        raise RuntimeError(
                            "DART ensemble buffer full: best snapshot plus live "
                            "trees exceed capacity; raise ntrees headroom"
                        )

                with span("qr.dart.drop"):
                    n_drop = self._trees_to_dropout(
                        rng, T_host - dropped_before_cleaning, dropout_factor_hist,
                        perf_valid_hist, best_va if va is not None else best_tr,
                    )
                    random_keep_iter = n_drop > 0 and rng.random() <= self.random_keep
                    dropped: list = []
                    if n_drop > 0:
                        dropped = self._select_dropout(rng, w_host[:T_host], contributions,
                                                       n_drop)
                    DROPPED += len(dropped)
                    dc_sum = np.float32(sum(contributions[t] for t in dropped))
                    dcw_sum = np.float32(sum(w_host[t] * contributions[t] for t in dropped))
                    ref_tr = best_tr if self.drop_on_best else m_tr
                    ref_va = best_va if self.drop_on_best else m_va
                    have_drop = len(dropped) > 0
                    k = np.float32(len(dropped))

                    # 1. the dropped trees leave the scores
                    delta_tr = delta_va = None
                    s_tr, s_va = scores_tr, scores_va
                    if have_drop:
                        if on_card:
                            ev = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
                            ev[0].record()
                        else:
                            t_delta = time.perf_counter()
                        w_drop = w_host[dropped]
                        delta_tr = train_delta(dropped, w_drop)
                        if va is not None:
                            delta_va = table.delta(dropped, w_drop, feats_va)
                        if on_card:
                            ev[1].record()
                            delta_events.append(ev)
                        else:
                            delta_events.append((time.perf_counter() - t_delta) * 1e3)
                        s_tr = scores_tr - delta_tr
                        if va is not None:
                            s_va = scores_va - delta_va

                # 2. fit on the dropped-out scores
                tree, d_tr, d_va, contribution = self._fit(m, tr, va, s_tr, cfg, md, docs)

                # 3. the new tree's first weight (dart.cc:944-1060)
                if nt == "LINESEARCH":
                    tw = self._linesearch(metric, tr, s_tr, d_tr)
                elif nt == "TREE_ADAPTIVE":
                    tw = s_ / (s_ + k)
                elif nt == "TREE_BOOST3":
                    tw = (s_ * np.float32(3)) / (s_ * np.float32(3) + k)
                elif nt in ("CONTR", "WCONTR"):
                    tw = (dc_sum / max(contribution, np.float32(1e-12))) * s_ if have_drop else s_
                elif nt == "LMART_ADAPTIVE":
                    tw = s_ / (np.float32(self.rate_drop) * np.float32(T_host) + s_)
                else:  # TREE / NONE / WEIGHTED / FOREST
                    tw = s_
                tw = np.float32(tw)

                with span("qr.dart.restore"):
                    new_idx = T_host
                    ens.push(tree, float(tw))
                    table.append(new_idx, tree, float(tw))

                    # 4. the restored weights (normalize_trees_restore_drop,
                    #    dart.cc:856-942); an iteration without drops keeps tw
                    if nt in ("TREE", "TREE_ADAPTIVE", "TREE_BOOST3"):
                        alpha = np.float32(3.0 if nt == "TREE_BOOST3" else 1.0)
                        w_new = (s_ * alpha) / (s_ * alpha + k)
                        factor = k / max(k + s_ * alpha, np.float32(1e-12))
                    elif nt == "NONE":
                        w_new, factor = s_, np.float32(1.0)
                    elif nt == "WEIGHTED":
                        dsum = np.float32(w_host[dropped].sum(dtype=np.float32))
                        w_new = s_ / (dsum + s_)
                        factor = dsum / (dsum + s_)
                    elif nt == "FOREST":
                        w_new = s_ / (np.float32(1.0) + s_)
                        factor = np.float32(1.0) / (np.float32(1.0) + s_)
                    elif nt == "LINESEARCH":
                        w_new = tw / max(tw + k, np.float32(1e-12))
                        factor = k / max(k + tw, np.float32(1e-12))
                    elif nt in ("CONTR", "WCONTR"):
                        dc = dcw_sum if nt == "WCONTR" else dc_sum
                        cl = (tw if nt == "WCONTR" else np.float32(1.0)) * contribution
                        tot = max(dc + cl, np.float32(1e-12))
                        w_new, factor = cl / tot, dc / tot
                    else:  # LMART_ADAPTIVE
                        w_new, factor = tw, np.float32(1.0)
                    w_new = np.float32(w_new if have_drop else tw)
                    factor = np.float32(factor if have_drop else 1.0)

                    kept = False
                    if self.keep_drop and have_drop:
                        # fitting after the drop, the dropped set left out for good
                        s_tr_fit = fma_f32(torch.tensor(tw), d_tr, s_tr)
                        s_va_fit = (fma_f32(torch.tensor(tw), d_va, s_va)
                                    if va is not None else None)
                        m_tr_fit, m_va_fit = self._metrics(metric, tr, va, s_tr_fit, s_va_fit)
                        fit, ref = (m_va_fit, ref_va) if va is not None else (m_tr_fit, ref_tr)
                        fit_improved = fit > np.float32(ref if np.isfinite(ref) else -3e38)
                        kept = bool(fit_improved or random_keep_iter)
                    if kept:
                        scores_tr, scores_va, m_tr, m_va = s_tr_fit, s_va_fit, m_tr_fit, m_va_fit
                        # X-DART: the dropped set goes for good (dart.cc:430-445)
                        w_host[dropped] = 0.0
                        w_host[new_idx] = tw
                        dropped_before_cleaning += len(dropped)
                    else:
                        # the dropped set comes back with renormalized weights: the
                        # restored weights are a scalar multiple of the dropped
                        # ones, so re-adding them is factor * the delta
                        f_t, w_t = torch.tensor(factor), torch.tensor(w_new)
                        scores_tr = fma_f32(w_t, d_tr, fma_f32(f_t, delta_tr, s_tr)
                                            if have_drop else s_tr)
                        if va is not None:
                            scores_va = fma_f32(w_t, d_va, fma_f32(f_t, delta_va, s_va)
                                                if have_drop else s_va)
                        w_host[dropped] = w_host[dropped] * factor
                        w_host[new_idx] = w_new
                    sync_weights()
                if not kept:
                    m_tr, m_va = self._metrics(metric, tr, va, scores_tr, scores_va, m_va)
                contributions.append(float(contribution))
                T_host += 1

                hist_tr.append(m_tr)
                hist_va.append(m_va if va is not None else np.nan)
                best_improved = ((m_va > best_va) if (va is not None and not self.best_on_train)
                                 else (m_tr > best_tr))
                if va is not None and self.best_on_train and m_va > best_va:
                    best_va = m_va
                if best_improved:
                    best_tr = m_tr
                    if not self.best_on_train and va is not None:
                        best_va = m_va
                    best_iter = m
                    with span("qr.dart.compact"):
                        ens, contributions, w_host, T_host = self._compact_zero_weights(
                            ens, contributions, w_host, T_host, table=table)
                    best_size = T_host
                    best_weights = w_host[:T_host].copy()
                    dropped_before_cleaning = 0
                    # periodic full rescore against drift (dart.cc:552-558)
                    if m - last_global_rescore > 10:
                        with span("qr.dart.rescore"):
                            scores_tr = train_rescore()
                            if va is not None:
                                scores_va = rescore_binned(ens, va.step, md)
                        RESCORES += 1
                        last_global_rescore = m
                        rescored.append(m)
            perf_valid_hist.append(m_va if va is not None else m_tr)
            if (partial_save and output_basename and (m + iter_offset) % partial_save == 0
                    and lead):
                # periodic snapshot as <base>.T<k>.xml (mart.cc:378-381)
                snapshot = self.ensemble
                self.ensemble = ens.live().to("cpu")
                self.save(f"{output_basename}.T{m + iter_offset}.xml")
                self.ensemble = snapshot
            iter_seconds.append(time.perf_counter() - t_iter)
            dropped_per_iter.append(len(dropped))
            dropped_sets.append([int(t) for t in dropped])
            if verbose and (m < 5 or m % 10 == 0 or best_improved):
                vtxt = f" {m_va:.6f}" if va is not None else ""
                print(f"# {m:5d} {m_tr:.6f}{vtxt} drop={len(dropped)} "
                      f"size={T_host - dropped_before_cleaning}"
                      f"{' *' if best_improved else ''}")

        # rollback: pop to the best model's size and restore its weights
        # (dart.cc:573-580)
        ens.num_trees = max(best_size, 1)
        if best_size > 0:
            ens.weight[:best_size] = torch.from_numpy(best_weights).to(device)
        self.ensemble = ens.live().to("cpu")
        self._tables_cache = None
        self.best_iteration = best_iter
        if on_card:
            torch.cuda.synchronize(device)
        self.history = {
            "train": hist_tr,
            "valid": hist_va,
            "best_iteration": best_iter,
            "best_valid": best_va if va is not None else None,
            "init_seconds": init_time,
            "train_seconds": time.perf_counter() - t_train,
            "iter_seconds": iter_seconds,
            "dropped_per_iter": dropped_per_iter,
            "dropped": dropped_sets,
            "rescored": rescored,
            "delta_ms": [e[0].elapsed_time(e[1]) if on_card else e for e in delta_events],
            "metric": repr(metric),
        }
        if verbose:
            print(f"# done: {self.ensemble.num_trees} trees kept")
        return self.history

    # -- dropout machinery (host) -----------------------------------------

    def _trees_to_dropout(self, rng, model_size, factor_hist, perf_hist, best_perf) -> int:
        """Adaptive dropout-count schedule (dart.cc:1095-1181)."""
        if rng.random() <= self.skip_drop or model_size <= 0:
            factor_hist.append(0.0)
            return 0
        at = self.adaptive_type
        last = factor_hist[-1]
        improved = perf_hist[-1] >= best_perf
        x = 0.0
        if at == "FIXED":
            if self.rate_drop >= 1:
                if self.rate_drop * 2 <= model_size:
                    x = self.rate_drop
            else:
                x = self.rate_drop * model_size
        elif at == "PLUS1_DIV2":
            x = last / 2 if improved else last + 1
        elif at == "PLUSHALF_DIV2":
            x = last / 2 if improved else last + 0.5
        elif at == "PLUSONETHIRD_DIV2":
            x = last / 2 if improved else last + 1.0 / 3
        elif at == "PLUSHALF_RESET":
            x = 0 if improved else last + 0.5
        elif at == "PLUSHALF_RESET_LB1_UB5":
            x = 1 if improved else min(5.0, last + 0.5)
        elif at == "PLUSHALF_RESET_LB1_UB10":
            x = 1 if improved else min(10.0, last + 0.5)
        elif at == "PLUSHALF_RESET_LB1_UBRD":
            x = 1 if improved else min(self.rate_drop * model_size, last + 0.5)
        # dart.cc:1176-1181: the cap is C integer division, and round() is
        # C's (half away from zero), not Python's banker's rounding
        x = min(x, model_size // 2)
        factor_hist.append(x)
        return int(np.floor(x + 0.5))

    def _select_dropout(self, rng, weights, contributions, k) -> list:
        """Pick the dropout set D (dart.cc:708-854)."""
        T = len(weights)
        contr = np.asarray(contributions[:T], np.float64)
        st = self.sample_type
        if st in ("UNIFORM", "TOP_FIFTY"):
            # dart.cc:721: round(size / 2) on integer division -> T // 2
            size = T if st == "UNIFORM" else T // 2
            idx = rng.permutation(size)
            return [int(i) for i in idx if weights[i] > 0][:k]
        if st in ("WEIGHTED", "WEIGHTED_INV", "CONTR", "CONTR_INV",
                  "WCONTR", "WCONTR_INV"):
            if st in ("WEIGHTED", "WEIGHTED_INV"):
                base = np.asarray(weights, np.float64).copy()
            elif st in ("CONTR", "CONTR_INV"):
                base = np.where(weights > 0, contr, 0.0)
            else:
                base = np.where(weights > 0, weights * contr, 0.0)
            inv = st.endswith("_INV")
            chosen: list = []
            avail = base > 0
            for _ in range(k):
                if not avail.any():
                    break
                p = np.where(avail, base, 0.0)
                s = p.sum()
                if s <= 0:
                    p = avail.astype(np.float64)
                    s = p.sum()
                p = p / s
                if inv:
                    p = np.where(avail, 1.0 - p, 0.0)
                    z = p.sum()
                    if z <= 0:
                        p = avail.astype(np.float64)
                        z = p.sum()
                    p = p / z
                i = int(rng.choice(T, p=p))
                chosen.append(i)
                avail[i] = False
            return chosen
        # TOP_WCONTR / LESS_WCONTR: extremal weighted contributions
        wc = np.asarray(weights, np.float64) * contr
        order = np.argsort(wc, kind="stable")
        if st == "TOP_WCONTR":
            order = order[::-1]
        return [int(i) for i in order[:k]]

    @staticmethod
    def _compact_zero_weights(ens: EnsembleTensors, contributions, w_host, T_host,
                              protect: int = 0, table: Optional[DropTable] = None):
        """filter_out_zero_weighted_trees with the contributions'
        compaction (ensemble.cc:149-169, dart.cc
        filter_out_zero_weighted_contributions): (ens, contributions,
        weights, T).  The zero pattern comes from the host weights.
        ``protect`` keeps the first slots even when zero-weighted (the
        capacity guard must keep the best snapshot's trees for the
        rollback).  The kept slots move to the head in order, in ``ens``
        and, when given, in ``table``."""
        keep = np.flatnonzero((w_host[:T_host] != 0) | (np.arange(T_host) < protect))
        if len(keep) == T_host:
            return ens, contributions, w_host, T_host
        new_T = len(keep)
        new = EnsembleTensors.empty(ens.capacity, ens.max_nodes, ens.weight.device)
        with span("qr.boost.readback"):
            idx = torch.from_numpy(keep).to(ens.weight.device)
        for f in ("feature", "threshold", "threshold_bin", "left", "right", "is_leaf",
                  "leaf_value"):
            getattr(new, f)[:new_T] = getattr(ens, f).index_select(0, idx)
        w2 = np.zeros_like(w_host)
        w2[:new_T] = w_host[keep]
        with span("qr.boost.readback"):  # a pageable upload syncs the stream
            new.weight.copy_(torch.from_numpy(w2))
        new.num_trees = new_T
        if table is not None:
            table.compact(keep)
        return new, [contributions[i] for i in keep], w2, new_T

    def _info_dict(self) -> dict:
        d = super()._info_dict()
        d.update({
            "sample-type": self.sample_type,
            "normalize-type": self.normalize_type,
            "adaptive-type": self.adaptive_type,
            "rate-drop": self.rate_drop,
            "skip-drop": self.skip_drop,
            "keep-drop": int(self.keep_drop),
            "best-on-train": int(self.best_on_train),
            "random-keep": self.random_keep,
            "drop-on-best": int(self.drop_on_best),
        })
        return d

    @classmethod
    def _ctor_kwargs_from_info(cls, info) -> dict:
        """The DART <info> tags of :meth:`_info_dict` back into constructor
        arguments, so a loaded model keeps its dropout configuration
        (dart.cc:59-107)."""
        g = cls._info_get
        flag = lambda s: bool(int(s))  # noqa: E731
        d = super()._ctor_kwargs_from_info(info)
        d.update(
            sample_type=g(info, "sample-type", str, "UNIFORM"),
            normalize_type=g(info, "normalize-type", str, "TREE"),
            adaptive_type=g(info, "adaptive-type", str, "FIXED"),
            rate_drop=g(info, "rate-drop", float, 0.1),
            skip_drop=g(info, "skip-drop", float, 0.0),
            keep_drop=g(info, "keep-drop", flag, False),
            best_on_train=g(info, "best-on-train", flag, False),
            random_keep=g(info, "random-keep", float, 0.0),
            drop_on_best=g(info, "drop-on-best", flag, False),
        )
        return d

    def __repr__(self):
        return (
            f"{self.NAME}(ntrees={self.ntrees}, shrinkage={self.shrinkage}, "
            f"nleaves={self.nleaves}, sample={self.sample_type}, "
            f"normalize={self.normalize_type}, adaptive={self.adaptive_type}, "
            f"rate_drop={self.rate_drop}, skip_drop={self.skip_drop}, "
            f"keep_drop={self.keep_drop})"
        )
