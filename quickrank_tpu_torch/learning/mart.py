"""MART, pointwise gradient-boosted regression trees (counterpart of
quickrank_tpu/learning/mart.py, after src/learning/forests/mart.cc:208-416).

Training.  Each boosting iteration computes pseudoresponses, grows a tree
(best-first, ``trees/grow.py``; best-k, ``trees/grow_bestk.py``; or
level-wise, ``trees/grow_level.py``), sets leaf outputs, adds the tree to
the train and valid scores with Kahan compensation, and evaluates the
metric; the host loop keeps the early stopping bookkeeping.  Everything runs
on the ``device`` given to :meth:`Mart.learn` (the CUDA card unless the
caller names another): CUDA tensors go through the histogram kernels
(``ops/kernel_histogram.py``), CPU tensors through their plain versions.

Reference semantics kept:
  * pseudoresponse = label - current score (mart.cc:418-431);
  * per-iteration doc subsampling (mart.cc:312-329) as a random k-of-N mask;
  * shrinkage as the pushed tree's weight (mart.cc:342);
  * early stop after ``esr`` iterations without a better validation score,
    with rollback to the best iteration (mart.cc:347-395);
  * ``warm_start`` resumes from the model's trees after a full rescoring
    pass (mart.cc:237-253).

Random draws (doc subsampling, feature sampling) come from a
``torch.Generator`` seeded from (seed, iteration, stream): they cannot
reproduce ``jax.random``'s bits.

Query-sharded training (``learn(mesh=group)``, a ``parallel.DataGroup``):
every rank runs this loop on its own block of the queries.  The histograms
and leaf sums are reduced over the ranks inside the growers
(``ops/histogram.py``), and :func:`eval_metric` gathers the per-query
metric values of every rank in global query order and sums them as one
rank would (JAX psums (numerator, denominator), mart.py:138-140); early
stopping and rollback read the reduced metrics only, so every rank keeps the
same ensemble, one rank's bit for bit.  Doc
subsampling draws per rank, feature sampling the same on every rank (JAX's
``fold_in(k1, axis_index)``, mart.py:485-488).  Rank 0 alone prints and
writes partial models.

Inference.  Scorer dispatch depends on the model's shape only: the
perfect-tree scorer when every tree has depth <= 5, QuickScorer otherwise
(any depth).  The device then picks kernel or plain version inside the
wrapper.  Per-tree columns (:meth:`Mart.partial_scores_dataset`) come from
the QuickScorer kernel's partial entry on the card and from the descent on
the CPU, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import (
    Dataset,
    PaddedDataset,
    gather_padded,
    shard_and_pad,
)
from quickrank_tpu_torch.learning.base import LTRAlgorithm, resolve_device
from quickrank_tpu_torch.metrics.metrics import Metric
from quickrank_tpu_torch.ops.binning import FLT_MAX, apply_bins, build_thresholds
from quickrank_tpu_torch.ops.kernel_perfect import score_perfect
from quickrank_tpu_torch.ops.kernel_qs import partial_score_blocks, score_qs
from quickrank_tpu_torch.ops.scoring import kahan_add, partial_scores, tree_delta_binned
from quickrank_tpu_torch.parallel.mesh import BlockOrder, DataGroup
from quickrank_tpu_torch.trees.grow import GrowConfig, fit_tree, leaf_outputs
from quickrank_tpu_torch.trees.grow_bestk import fit_tree_bestk
from quickrank_tpu_torch.trees.grow_cluster import (
    TILE,
    fit_tree_clustered,
    payload_columns_required,
)
from quickrank_tpu_torch.trees.grow_level import fit_tree_levelwise
from quickrank_tpu_torch.trees.perfect import ensemble_to_perfect
from quickrank_tpu_torch.trees.qs import ensemble_to_qs
from quickrank_tpu_torch.trees.structs import EnsembleTensors

#: deepest tree the perfect-tree scorer embeds
PERFECT_MAX_DEPTH = 5

#: ROADMAP.md §A entry for bin ids wider than a byte on CUDA
_WIDE_BINS_ITEM = "§A item 12 (bins wider than u8 on CUDA)"
#: ROADMAP.md §A entry for what query-sharded training does not cover yet
SHARDING_ITEM = "§A item 10b (the rest of parallel training)"


def refuse_group(what: str, mesh) -> None:
    """Raise for ``mesh`` (a ``DataGroup`` or anything else) where ``what``
    does not run under one, naming ROADMAP.md's item."""
    if mesh is not None:
        raise NotImplementedError(
            f"{what} under a query-sharded group is not ported to "
            f"quickrank_tpu_torch yet: ROADMAP.md {SHARDING_ITEM}"
        )


@dataclasses.dataclass
class StepData:
    """The tensors one boosting step reads (train or valid fold), all on
    the training device."""

    binned: torch.Tensor  # u8 [N, W] (int32 beyond 256 bins, CPU only)
    labels: torch.Tensor  # f32 [N]
    labels2d: torch.Tensor  # f32 [Q, D]
    doc_mask: torch.Tensor  # bool [N]
    pad_index: torch.Tensor  # int64 [Q, D]
    inv_q: torch.Tensor  # int64 [N]
    inv_slot: torch.Tensor  # int64 [N]
    slot_mask: torch.Tensor  # bool [Q, D]
    query_mask: torch.Tensor  # bool [Q]
    nvalid: torch.Tensor  # int32 [Q]
    thresholds: torch.Tensor  # f32 [W, B]
    #: under a group, where every rank's real queries sit in global order
    #: (the metric's order-free reduction, :func:`reduce_queries`)
    queries: Optional[BlockOrder] = None


@dataclasses.dataclass
class TrainData:
    """Padded layout, binned step tensors on the device, and the host copy
    of the threshold tables.  Under a query-sharded group the layout is this
    rank's block and ``group`` carries the real docs of all ranks."""

    padded: PaddedDataset
    step: StepData
    thresholds: np.ndarray  # f32 [W, B], host
    num_real_features: int
    group: Optional[DataGroup] = None

    @staticmethod
    def build(ds: Dataset, nthresholds: int,
              thresholds: Optional[np.ndarray] = None,
              device=None, group: Optional[DataGroup] = None,
              force_dims: Optional[tuple] = None,
              num_docs: Optional[int] = None) -> "TrainData":
        """Bin ``ds`` and move its step tensors to ``device``.  With
        ``group`` (and no ``force_dims``) ``ds`` is the whole dataset and this
        rank lays out its own block of ``shard_and_pad(ds, world_size)``, on
        the group's device; the tables come from all of ``ds``.  With
        ``force_dims`` ``ds`` is this process's block already
        (``parallel/multihost.py``), laid out with the agreed geometry, and
        ``num_docs`` counts the real docs of all processes."""
        device = resolve_device(group.device if group is not None else device)
        if group is None:
            padded = shard_and_pad(ds)
        elif force_dims is None:
            padded = shard_and_pad(ds, group.world_size, block=group.rank)
            group = group.with_num_docs(ds.num_docs)
        else:
            padded = shard_and_pad(ds, force_dims=force_dims)
            group = group.with_num_docs(num_docs)
        if thresholds is None:
            thresholds, _ = build_thresholds(ds.features, nthresholds)
        binned = apply_bins(padded.features, np.asarray(thresholds))
        # the JAX package pads the feature axis to its kernel's feature
        # group (mart.py:186-202), with at least 8 pad columns; pad columns
        # bin every doc to 0 and carry FLT_MAX thresholds, so a split on
        # one sends every doc left and is never chosen.  The port keeps the
        # same width so that histograms and trees line up with JAX's.
        F = binned.shape[1]
        g_align = 64 if thresholds.shape[1] <= 64 else 32
        f_blk = (F + g_align - 1) // g_align * g_align
        if f_blk - F < 8:
            f_blk += g_align
        if f_blk != F:
            binned = np.pad(binned, ((0, 0), (0, f_blk - F)))
            thresholds = np.pad(thresholds, ((0, f_blk - F), (0, 0)),
                                constant_values=FLT_MAX)
        B = thresholds.shape[1]
        if B > 256 and device.type == "cuda":
            raise NotImplementedError(
                f"{B} bins need bin ids wider than a byte, which the CUDA "
                f"histogram path does not take yet: ROADMAP.md {_WIDE_BINS_ITEM}"
            )
        wire = torch.from_numpy(binned.astype(np.uint8 if B <= 256 else np.int32))
        to = lambda t: t.to(device)  # noqa: E731
        sd = StepData(
            binned=to(wire),
            labels=to(padded.labels),
            labels2d=to(gather_padded(padded.labels, padded.pad_index,
                                      padded.slot_mask)),
            doc_mask=to(padded.doc_mask),
            pad_index=to(padded.pad_index),
            inv_q=to(padded.inv_q),
            inv_slot=to(padded.inv_slot),
            slot_mask=to(padded.slot_mask),
            query_mask=to(padded.query_mask),
            nvalid=to(padded.nvalid),
            thresholds=to(torch.from_numpy(np.ascontiguousarray(thresholds))),
        )
        if group is not None:
            sd.queries = BlockOrder.build(group, sd.nvalid)
        return TrainData(padded=padded, step=sd, thresholds=thresholds,
                         num_real_features=ds.num_features, group=group)

    @property
    def num_bins(self) -> int:
        return int(self.thresholds.shape[1])

    @property
    def num_docs(self) -> int:
        """Real docs of the run: all ranks' under a group, else this
        layout's (the fixed-point scale's count, ``GrowConfig.num_docs``)."""
        if self.group is not None:
            return self.group.num_docs
        return int(self.padded.doc_mask.sum())


def build_valid_traindata(tr: TrainData, valid: Optional[Dataset],
                          nthresholds: int, device) -> Optional[TrainData]:
    """Validation fold binned with the training run's thresholds (real
    feature rows only).  A narrower validation matrix would misroute global
    feature ids, so it is refused."""
    if valid is None:
        return None
    if valid.num_features < tr.num_real_features:
        raise ValueError(
            f"validation set has {valid.num_features} features but training "
            f"used {tr.num_real_features}: trees split on global feature ids, "
            "so pad the validation features to the training width"
        )
    return TrainData.build(valid, nthresholds,
                           thresholds=tr.thresholds[: valid.num_features],
                           device=device, group=tr.group)


def per_query(metric: Metric, sd: StepData, scores: torch.Tensor) -> torch.Tensor:
    """The metric of each query of flat padded scores: ``[Q]``."""
    s = gather_padded(scores, sd.pad_index, sd.slot_mask)
    return metric.evaluate_per_query(s, sd.labels2d, sd.slot_mask, sd.nvalid)


def reduce_queries(metric: Metric, pq: torch.Tensor, sd: StepData,
                   group: Optional[DataGroup] = None) -> torch.Tensor:
    """The (num, den) mean of metric.h:77-106 of per-query values ``[Q]``
    (a 0-d tensor), or of each row of ``[C, Q]`` (``[C]``).  Under ``group``
    every rank's real queries are gathered first, in global query order
    (one collective, ``sd.queries``), and every rank sums them as one rank
    sums its queries: the value is one rank's bit for bit, where a sum of
    the ranks' (num, den) (JAX mart.py:138-140) would depend on how the
    queries are split."""
    if group is None:
        query_mask, num_docs = sd.query_mask, sd.doc_mask.sum()
    else:
        pq = sd.queries.gather(pq)
        query_mask = torch.ones(pq.shape[-1], dtype=torch.bool, device=pq.device)
        num_docs = torch.tensor(sd.queries.total, device=pq.device)
    rows = [metric.finalize(*metric.aggregate(r, query_mask, num_docs))
            for r in (pq if pq.dim() > 1 else pq[None])]
    return torch.stack(rows) if pq.dim() > 1 else rows[0]


def eval_metric(metric: Metric, sd: StepData, scores: torch.Tensor,
                group: Optional[DataGroup] = None) -> torch.Tensor:
    """Dataset-level metric of flat padded scores (0-d): per-query values,
    then :func:`reduce_queries`."""
    return reduce_queries(metric, per_query(metric, sd, scores), sd, group)


class Mart(LTRAlgorithm):
    NAME = "MART"
    #: Newton leaf outputs (sum lambda / sum w); LambdaMart turns this on
    _newton = False
    #: trains under a query-sharded group (learners whose draws or hooks
    #: are not sharded yet turn it off)
    _shardable = True

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
        """The JAX package's hyperparameters (quicklearn's defaults,
        src/quicklearn.cc:97-140, except 255 thresholds).  ``growth`` is
        "best" (best-first, reference-faithful) or "level" (depth-wise to
        ``max_depth`` or ceil(log2(nleaves))) or "bestk" (best-first priority
        with up to ``split_pack`` heap leaves split per histogram pass;
        ``split_pack=1`` is exact best-first).  ``cluster="on"`` grows
        best-first trees over a node-clustered copy of the bin matrix
        (``trees/grow_cluster.py``; the same split rule, another doc layout);
        "off" and "auto" grow in dataset order."""
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
        self.best_iteration: int = -1
        self.history: dict = {}
        self._tables_cache = None
        #: depth bound of a model loaded from XML (trees of unknown shape)
        self._depth_bound: Optional[int] = None

    # -- hooks for subclasses ------------------------------------------------

    def _gradients(self, sd: StepData, scores, sample_mask, full_mask=False):
        """(pseudoresponses, newton_weights or None): label - score
        (mart.cc:418-431)."""
        return (sd.labels - scores).float(), None

    def _grow_config(self, num_bins: int, num_real_features: int = 0,
                     num_docs: int = 0) -> GrowConfig:
        nleaves = self.nleaves
        if self.growth == "level":
            nleaves = 2 ** self._level_depth()
        return GrowConfig(
            nleaves=nleaves, min_leaf_support=self.minleafsupport,
            num_bins=num_bins, max_features=self.max_features,
            newton=self._newton, max_depth=self.max_depth,
            collapse_factor=self.collapse_leaves_factor,
            num_real_features=num_real_features, num_docs=num_docs,
        )

    def _tree_weight(self) -> float:
        return self.shrinkage

    def _post_init(self, tr: "TrainData") -> None:
        """Subclass hook run once after data preparation (JAX mart.py:1056)."""

    def _update_presence(self, m: int, tr: "TrainData", scores_tr, generator):
        """Subclass hook: iteration ``m``'s doc pool, bool [N], or None to
        keep the last one (the negative-sampling learners; JAX
        mart.py:1059)."""
        return None

    def _post_iteration(self, m: int, improved: bool) -> None:
        """Subclass hook after each boosting iteration (adaptive samplers;
        JAX mart.py:1064)."""

    def _descend_depth(self) -> int:
        """Bound on tree depth for the bin-space descent: the grower's, and
        at least that of the trees a model loaded from XML carries (a warm
        start descends both)."""
        return max(self._grower_depth(), self._depth_bound or 0)

    def _grower_depth(self) -> int:
        if self.growth == "level":
            return self._level_depth() + 1
        if self.max_depth:
            return min(self.max_depth + 1, self.nleaves)
        return self.nleaves

    def _level_depth(self) -> int:
        return self.max_depth or max(1, (self.nleaves - 1).bit_length())

    def _generator(self, m: int, stream: int, rank: Optional[int] = None) -> torch.Generator:
        """Host generator of iteration ``m``'s draws: stream 0 samples docs,
        stream 1 features.  ``rank`` gives each rank of a group its own
        draws (doc subsampling)."""
        key = [self.seed, m, stream] + ([rank] if rank is not None else [])
        seed = np.random.SeedSequence(key).generate_state(1)[0]
        return torch.Generator().manual_seed(int(seed))

    def _sample_mask(self, sd: StepData, generator, presence):
        """Random subset of subsample*N present docs (a count when
        subsample > 1), the shuffle-and-take of mart.cc:312-329."""
        if self.subsample == 1.0:
            return presence
        n = int(presence.sum())
        if self.subsample > 1.0:
            k = min(int(self.subsample), n)
        else:
            k = min(max(int(np.float32(self.subsample) * np.float32(n)), 1), n)
        r = torch.rand(presence.shape[0], generator=generator).to(presence.device)
        r = torch.where(presence, r, torch.inf)
        kth = torch.sort(r).values[max(k - 1, 0)]
        return presence & (r <= kth)

    def _cluster_applicable(self, sd: StepData, cfg: GrowConfig) -> bool:
        """Whether the node-clustered best-first grower runs: asked for with
        ``cluster="on"`` ("auto" resolves to off, as in the JAX package), and
        u8 bins, tile-aligned docs, payload room in the pad columns and no
        collapse (the requirements of ``trees/grow_cluster.py``)."""
        if self.cluster != "on" or self.growth != "best":
            return False
        N, W = sd.binned.shape
        return (sd.binned.dtype == torch.uint8 and N % TILE == 0
                and W - (cfg.num_real_features or W) >= payload_columns_required()
                and cfg.collapse_factor == 0.0)

    def _fit_and_assign(self, tr: "TrainData", grad, smask, cfg, generator,
                        weights=None):
        """(tree, node_of_doc, leaves_done): the level-wise grower sets
        leaf values itself; the best-first growers (dataset order or
        node-clustered) and best-k leave them to :func:`leaf_outputs`."""
        sd, group = tr.step, tr.group
        if self.growth == "level":
            tree, node = fit_tree_levelwise(
                sd.binned, grad, smask, sd.thresholds, self._level_depth(),
                cfg, generator, weights=weights, group=group,
            )
            return tree, node, True
        thresholds = torch.from_numpy(tr.thresholds)
        if self.growth == "bestk":
            tree, node = fit_tree_bestk(sd.binned, grad, smask, thresholds, cfg,
                                        self.split_pack, generator, group=group)
        elif self._cluster_applicable(sd, cfg):
            tree, node = fit_tree_clustered(sd.binned, grad, smask, thresholds, cfg,
                                            generator)
        else:
            tree, node = fit_tree(sd.binned, grad, smask, thresholds, cfg, generator,
                                  group=group)
        return tree, node, False

    # -- the boosting step ---------------------------------------------------

    def _step(self, ens: EnsembleTensors, scores_tr, scores_va, m: int,
              tr: TrainData, va: Optional[TrainData], metric: Metric,
              cfg: GrowConfig, presence: Optional[torch.Tensor] = None):
        """One boosting iteration: pushes a tree into ``ens`` and returns
        (train Kahan pair, valid Kahan pair, train metric, valid metric).
        ``presence`` is the doc pool of a presence hook (None: every doc)."""
        sd, group = tr.step, tr.group
        pool = sd.doc_mask if presence is None else presence & sd.doc_mask
        rank = group.rank if group is not None else None
        smask = self._sample_mask(sd, self._generator(m, 0, rank), pool)
        grad, w = self._gradients(sd, scores_tr[0], smask,
                                  full_mask=self.subsample == 1.0 and presence is None)
        w = w if self._newton else None
        tree, node, leaves_done = self._fit_and_assign(
            tr, grad, smask, cfg, self._generator(m, 1), weights=w)
        if not leaves_done:
            tree = leaf_outputs(tree, node, grad, smask, weights=w, group=group,
                                num_docs=cfg.num_docs)
        shrinkage = torch.tensor(self._tree_weight(), dtype=torch.float32,
                                 device=sd.binned.device)
        ens.push(tree, self._tree_weight())
        # every doc was routed during the fit: the train update is a leaf
        # value gather.  Scores carry a Kahan term, the float32 analog of
        # the reference's double accumulator (include/types.h:28-35), with
        # the step fused as XLA fuses it (ops/scoring.py).
        d_tr = tree.leaf_value[node.long().clamp(min=0)]
        s_tr = kahan_add(scores_tr[0], scores_tr[1], shrinkage, d_tr)
        m_tr = eval_metric(metric, sd, s_tr[0], group)
        if va is None:
            return s_tr, scores_va, m_tr, None
        d_va = tree_delta_binned(va.step.binned, tree, self._descend_depth())
        s_va = kahan_add(scores_va[0], scores_va[1], shrinkage, d_va)
        return s_tr, s_va, m_tr, eval_metric(metric, va.step, s_va[0], group)

    # -- training ------------------------------------------------------------

    def _refuse_group(self, mesh) -> None:
        """What does not train under a query-sharded group raises, naming
        ROADMAP.md's item, before any data is touched."""
        if mesh is None:
            return
        if not isinstance(mesh, DataGroup):
            raise NotImplementedError(
                f"learn(mesh=...) takes a parallel.DataGroup (a 1-D query-sharded "
                f"group), got {type(mesh).__name__}; other meshes, such as the 2-D "
                f"data x feature mesh, are ROADMAP.md {SHARDING_ITEM}"
            )
        what = self.group_refusal()
        if what:
            refuse_group(what, mesh)

    def _train_data(self, train, device, mesh: Optional[DataGroup]) -> TrainData:
        """``train`` laid out and binned on ``device`` (this rank's block on
        the group's device under ``mesh``), or ``train`` itself when it is a
        ``TrainData`` already (``parallel/multihost.py``)."""
        if not isinstance(train, TrainData):
            return TrainData.build(train, self.nthresholds, device=device, group=mesh)
        if (mesh is None) != (train.group is None) or (
                mesh is not None and train.group.rank != mesh.rank):
            raise ValueError("a TrainData trains with mesh= the group it was built "
                             "for, and without one when it was built without")
        return train

    def group_refusal(self):
        if not self._shardable:
            return self.NAME
        if self.cluster == "on":
            return 'cluster="on" (the node-clustered grower)'
        return None

    def learn(self, train, valid: Optional[Dataset] = None,
              metric: Optional[Metric] = None, verbose: bool = True,
              device=None, mesh: Optional[DataGroup] = None, warm_start: bool = False,
              partial_save: int = 0, output_basename: str = "") -> dict:
        """Train on ``device``: the CUDA card by default (the kernels; an
        error without one), or "cpu" (the plain versions).  With
        ``warm_start`` and a model, training resumes at iteration
        ``num_trees`` after a full rescoring pass, the reference's
        --restart-train (mart.cc:237-253).  With ``partial_save`` and an
        ``output_basename`` the model so far is saved every ``partial_save``
        iterations as ``<output_basename>.T<iteration>.xml`` (mart.cc:378-381).
        With ``mesh``, a ``parallel.DataGroup``, this rank trains on its
        block of ``train`` (or on ``train``, this process's ``TrainData``
        from ``parallel/multihost.py``) on the group's device, and every rank
        returns the same model.  Returns the history dict: per-iteration
        train and valid metric (the new iterations only), best iteration,
        times."""
        self._refuse_group(mesh)
        metric = metric or self.default_metric()
        t_init = time.time()
        tr = self._train_data(train, device, mesh)
        device = tr.step.binned.device
        verbose = verbose and (mesh is None or mesh.rank == 0)
        va = build_valid_traindata(tr, valid, self.nthresholds, device)
        cfg = self._grow_config(tr.num_bins, tr.num_real_features, tr.num_docs)
        ens = EnsembleTensors.empty(self.ntrees, cfg.max_nodes, device)

        def zeros(t: Optional[TrainData]):
            n = t.padded.num_docs_padded if t is not None else 1
            z = torch.zeros(n, dtype=torch.float32, device=device)
            return z, z.clone()

        scores_tr, scores_va = zeros(tr), zeros(va)
        start_iter = 0
        if warm_start and self.ensemble is not None and self.ensemble.num_trees > 0:
            # a loaded model has no bin-space thresholds, and an in-process
            # one has those of its own run's tables: both are rebuilt against
            # this run's tables, so that binned routing is the value routing
            src = rebin_ensemble(self.ensemble.live(), tr.thresholds, force=True)
            _copy_into(ens, src.to(device))
            start_iter = ens.num_trees
            md = self._descend_depth()
            # the live trees only: one Kahan step per tree, as training took
            scores_tr = (rescore_binned(src, tr.step, md), scores_tr[1])
            if va is not None:
                scores_va = (rescore_binned(src, va.step, md), scores_va[1])
        self._train_metric = metric
        self._post_init(tr)
        uses_presence = type(self)._update_presence is not Mart._update_presence
        presence = None
        init_time = time.time() - t_init

        hist_tr, hist_va, iter_seconds = [], [], []
        best_va, best_it, best_scores = -np.inf, -1, None
        if verbose:
            print(f"# {self.NAME}: {self!r}")
            print("# iter. training validation")
        t_train = time.time()
        for m in range(start_iter, self.ntrees):
            t_iter = time.time()
            if uses_presence:
                # stream 2: the hook's own draws
                new = self._update_presence(m, tr, scores_tr[0], self._generator(m, 2))
                presence = presence if new is None else new
            scores_tr, scores_va, d_tr, d_va = self._step(
                ens, scores_tr, scores_va, m, tr, va, metric, cfg, presence)
            m_tr = float(d_tr)
            m_va = float(d_va) if va is not None else float("nan")
            iter_seconds.append(time.time() - t_iter)
            hist_tr.append(m_tr)
            hist_va.append(m_va)
            improved = False
            if va is not None and m_va > best_va:
                best_va, best_it, improved = m_va, m, True
                best_scores = scores_tr[0].clone()
            elif va is None and m_tr > max(hist_tr[:-1], default=-np.inf):
                improved = True
            self._post_iteration(m, improved)
            if (partial_save and output_basename and (m + 1) % partial_save == 0
                    and (mesh is None or mesh.rank == 0)):
                snapshot = self.ensemble
                self.ensemble = ens.live().to("cpu")
                self.save(f"{output_basename}.T{m + 1}.xml")
                self.ensemble = snapshot
            if verbose and (m < 5 or (m + 1) % 10 == 0 or improved):
                vtxt = f" {m_va:.6f}" if va is not None else ""
                print(f"# {m + 1:5d} {m_tr:.6f}{vtxt}{' *' if improved else ''}")
            if va is not None and self.esr and m - best_it >= self.esr:
                break

        if va is not None and best_it >= 0:
            # rollback to the best model (mart.cc:390-395)
            ens.num_trees = best_it + 1
        self.ensemble = ens.live().to("cpu")
        self._tables_cache = None
        self.best_iteration = best_it if va is not None else self.ntrees - 1
        train_time = time.time() - t_train
        self.history = {
            "train": hist_tr,
            "valid": hist_va,
            "best_iteration": self.best_iteration,
            "best_valid": best_va if va is not None else None,
            "init_seconds": init_time,
            "train_seconds": train_time,
            "iter_seconds": iter_seconds,
            "metric": repr(metric),
        }
        #: the scores training carried on the train fold for the model it
        #: returns (after any rollback), flat padded order (this rank's block
        #: under a group): the Kahan sum a rescoring of the model must
        #: reproduce
        self.train_scores = best_scores if va is not None and best_it >= 0 else scores_tr[0]
        if verbose:
            print(f"# done: {self.ensemble.num_trees} trees kept, "
                  f"init {init_time:.2f}s, train {train_time:.2f}s")
        return self.history

    #: hyperparameters that must match for a --restart-train resume
    #: (mart.cc:499-504: shrinkage within 1e-6, the others exactly)
    _RESTART_EXACT = ("nthresholds", "nleaves", "minleafsupport", "esr")

    def import_model_state(self, other: LTRAlgorithm) -> None:
        """Adopt ``other``'s ensemble for a training resume, refusing on a
        hyperparameter mismatch (mart.cc:493-517): a resume with, say,
        another shrinkage would corrupt the model without an error."""
        if not isinstance(other, Mart):
            raise ValueError(
                f"restart-train: {self.NAME} cannot import model state from "
                f"{other.NAME}"
            )
        diffs = []
        if abs(self.shrinkage - other.shrinkage) > 1e-6:
            diffs.append(
                f"shrinkage: {self.shrinkage} (requested) != "
                f"{other.shrinkage} (loaded model)"
            )
        for name in self._RESTART_EXACT:
            a, b = getattr(self, name), getattr(other, name)
            if a != b:
                diffs.append(f"{name}: {a} (requested) != {b} (loaded model)")
        if diffs:
            raise ValueError(
                "restart-train: models not compatible for restart "
                "(mart.cc:493-517): " + "; ".join(diffs)
            )
        self.ensemble = other.ensemble
        self._depth_bound = other._depth_bound

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

    def device_scorer(self, ds: Dataset, device=None):
        """(fn, features on ``device``): ``fn`` maps the uploaded features to
        scores on the device, so timing loops upload once."""
        device = resolve_device(device)
        fn, tables = self._dispatch_scorer(device)
        X = torch.from_numpy(np.ascontiguousarray(ds.features, np.float32))
        return (lambda x: fn(x, tables)), X.to(device)

    def score_dataset(self, ds: Dataset, device=None) -> np.ndarray:
        fn, X = self.device_scorer(ds, device)
        return fn(X).cpu().numpy()

    def get_weights(self) -> np.ndarray:
        ens = self._require_model()
        return ens.weight[: ens.num_trees].cpu().numpy()

    def update_weights(self, weights: np.ndarray) -> None:
        """Set per-tree weights, dropping zero-weighted trees
        (ensemble.cc:149-192)."""
        ens = self._require_model()
        T = ens.num_trees
        w = np.zeros((ens.capacity,), np.float32)
        w[:T] = np.asarray(weights, np.float32)[:T]
        keep = torch.from_numpy(np.flatnonzero(w != 0.0))
        self.ensemble = dataclasses.replace(
            ens, **{k: getattr(ens, k)[keep.to(ens.feature.device)]
                    for k in ("feature", "threshold", "threshold_bin", "left", "right",
                              "is_leaf", "leaf_value")},
            weight=torch.from_numpy(w)[keep].to(ens.weight.device),
            num_trees=int(keep.numel()))
        self._tables_cache = None

    def feature_importances(self, num_features: Optional[int] = None,
                            normalize: bool = True) -> np.ndarray:
        """Split-count feature importances over the live trees: how many
        internal nodes split on each feature id, float64 ``[num_features]``
        (default: the largest used id + 1), normalized to sum 1 unless
        ``normalize=False`` (JAX mart.py:1161)."""
        h = self._require_model().live().numpy()
        used = h["feature"][~h["is_leaf"]]
        used = used[used >= 0]
        width = int(num_features) if num_features else (
            int(used.max()) + 1 if used.size else 0)
        imp = np.bincount(used, minlength=width).astype(np.float64)[:width]
        if normalize and imp.sum() > 0:
            imp /= imp.sum()
        return imp

    def partial_scores_dataset(self, ds: Dataset, device=None) -> np.ndarray:
        """Per-tree unweighted scores float32 ``[docs, capacity]`` of ``ds``
        in dataset order (the --detailed file; Cleaver's input): on the card
        the QuickScorer kernel's partial entry, blocks of trees at a time;
        on the CPU the descent (``ops/scoring.py::partial_scores``), as the
        JAX package computes them off the TPU.  Bitwise equal either way."""
        device = resolve_device(device)
        ens = self._require_model()
        X = torch.from_numpy(np.ascontiguousarray(ds.features, np.float32))
        if device.type != "cuda":
            return partial_scores(X.to(device), ens.to(device),
                                  max_depth=self._descend_depth()).cpu().numpy()
        out = np.zeros((X.shape[0], ens.capacity), np.float32)
        for t0, t1, cols in partial_score_blocks(X.to(device), ensemble_to_qs(ens).to(device)):
            out[:, t0:t1] = cols.cpu().numpy()
        return out

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
        algo.ensemble, max_depth = parse_ensemble(root)
        algo._depth_bound = max_depth + 1
        return algo

    def __repr__(self):
        return (
            f"{self.NAME}(ntrees={self.ntrees}, shrinkage={self.shrinkage}, "
            f"nleaves={self.nleaves}, minls={self.minleafsupport}, "
            f"nthresholds={self.nthresholds}, esr={self.esr}, "
            f"subsample={self.subsample}, max_features={self.max_features})"
        )


def rescore_binned(ens: EnsembleTensors, sd: StepData, max_depth: int) -> torch.Tensor:
    """Full scoring pass f32 [N] over binned docs, Kahan-compensated over the
    slots of ``ens`` in order (warm starts: the reference recomputes scores
    rather than checkpointing them, mart.cc:237-253).

    On the card the pass rides bin-space QuickScorer tables and the
    QuickScorer kernel on the u8 bin matrix itself (no float32 copy of it);
    on the CPU it is a scan of per-tree bin-space descents.  Both keep the
    fused Kahan step of the training carry, so with the model's live trees
    the result is bitwise the scores training carried."""
    if sd.binned.device.type == "cuda":
        return score_qs(sd.binned, ensemble_to_qs(ens, space="bin").to(sd.binned.device))
    s = torch.zeros(sd.binned.shape[0], dtype=torch.float32)
    c = torch.zeros_like(s)
    zero = torch.zeros((), dtype=torch.float32)
    for t in range(ens.capacity):
        d = tree_delta_binned(sd.binned, ens.tree(t), max_depth)
        s, c = kahan_add(s, c, ens.weight[t] if t < ens.num_trees else zero, d)
    return s


def rebin_ensemble(ens: EnsembleTensors, thresholds: np.ndarray,
                   force: bool = False) -> EnsembleTensors:
    """Fill missing bin-space split points (``threshold_bin == -1``, the
    XML load sentinel) from the value-space thresholds.

    By the binning's construction ``bin(v) <= t  <=>  v <= thresholds[t]``,
    so the bin-space twin of a split at value ``thr`` is the largest ``t``
    with ``thresholds[f][t] <= thr``: exact when ``thr`` is an entry of the
    table (always, for a model trained on these tables), the closest
    quantization otherwise (rtnode_histogram.cc:227-253).

    ``force=True`` recomputes every internal node's bin id, as a warm start
    must: an in-process model carries the bin ids of its own run's tables,
    which misroute against another dataset's.  Against the same tables the
    recompute changes nothing."""
    h = ens.numpy()
    feat, tbin = h["feature"], h["threshold_bin"].copy()
    need = ~h["is_leaf"] & (feat >= 0)
    if not force:
        need &= tbin < 0
    if not need.any():
        return ens
    ti, ni = np.nonzero(need)
    rows = np.asarray(thresholds)[feat[ti, ni]]  # [K, B]
    thr = h["threshold"][ti, ni][:, None]
    tbin[ti, ni] = np.clip((rows <= thr).sum(axis=1) - 1, 0, None)
    return dataclasses.replace(
        ens, threshold_bin=torch.from_numpy(tbin).to(ens.threshold_bin.device))


def _copy_into(dst: EnsembleTensors, src: EnsembleTensors) -> None:
    """Copy ``src``'s live trees into the head of ``dst``, in place (the
    capacity grows for a warm start; ``src``'s node budget must fit)."""
    T, n = src.num_trees, src.max_nodes
    if dst.max_nodes < n or dst.capacity < T:
        raise ValueError(
            f"warm start: the model has {T} trees of up to {n} nodes, the "
            f"run holds {dst.capacity} trees of {dst.max_nodes} nodes; raise "
            "ntrees (and nleaves) to at least the model's"
        )
    for k in ("feature", "threshold", "threshold_bin", "left", "right",
              "is_leaf", "leaf_value"):
        getattr(dst, k)[:T, :n] = getattr(src, k)[:T]
    dst.weight[:T] = src.weight[:T]
    dst.num_trees = T
