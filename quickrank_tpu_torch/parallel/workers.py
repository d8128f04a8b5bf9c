"""Rank entry points for ``parallel/launch.py::run_ranks``: each runs in one
rank of a group and returns what the launcher gathers.

  * :func:`driver_rank`: quicklearn's pipeline (``driver.run``) under the
    group; rank 0 alone prints, writes the model and scores ``--test``;
  * :func:`train_rank`: one learner trained from a spec (``chip_smoke.py``,
    the parallel tests): the Mart family and DART on a shared ``TrainData``,
    the linear rankers and MetaCleaver on the datasets;
  * :func:`optimize_rank`: Cleaver on a saved model;
  * :func:`sample_rank`: doc subsampling's masks, the one draw of the
    run (held against the unsharded masks);
  * :func:`grow_rank`: one tree a given (gradient, weight) pair through a
    learner's grower, with no boosting loop around it: the harness that
    holds the sharded growers against a reference given the same gradients;
  * :func:`multihost_rank`: the multi-host data path on this host (each
    rank loads only its query block, ``parallel/multihost.py``), then
    training; :func:`layout_rank`: its ``TrainData`` beside the one
    ``TrainData.build`` lays out from the whole dataset;
  * :func:`descend_rank`: a model's weighted trees summed over this rank's
    block of a 2-D mesh by the owners' node tests, beside the QuickScorer
    sum over the data axis's whole bin matrix;
  * :func:`batch_rank`: several of the above in one launch;
  * :func:`fail_rank`: one rank raises while the others wait in a
    collective (the launcher's failure path).

Under a 2-D data x feature mesh (``run_ranks(..., num_feat_shards=k)``) the
rank's ``group`` is its ``parallel.mesh.Mesh2D``, and a spec's ``mesh``
(``(num_shards, num_feat_shards)``) runs the job on a smaller mesh inside
the launch (:func:`sub_mesh`).

Datasets travel as paths of ``.npz`` files (:func:`save_dataset`), so that
large folds are not pickled through the launcher.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.parallel.mesh import DataGroup, Mesh2D, data_group


def save_dataset(ds: Dataset, path: str) -> str:
    np.savez(path, features=ds.features, labels=ds.labels,
             query_offsets=ds.query_offsets, qids=ds.qids)
    return path


def load_dataset(src) -> Optional[Dataset]:
    """A ``Dataset`` as is, or the one an ``.npz`` path holds; None stays None."""
    if src is None or isinstance(src, Dataset):
        return src
    with np.load(src) as z:
        return Dataset(z["features"], z["labels"], z["query_offsets"], z["qids"])


def ensemble_arrays(model) -> dict:
    """The live trees' fields as host numpy arrays (comparable across ranks
    and runs); a RankBoost model's weak rankers."""
    if hasattr(model, "features_"):
        return {"feature": model.features_, "theta": model.thetas_, "alpha": model.alphas_}
    return model.ensemble.live().numpy()


def solo_group(group: DataGroup) -> DataGroup:
    """A one-rank group of this rank alone, in the launch of ``group``: a
    group's run against the unsharded one without another launch.  Every
    rank makes every rank's (``torch.distributed.new_group`` is collective)."""
    import torch.distributed as dist

    subs = [dist.new_group([r], backend=group.backend) for r in range(group.world_size)]
    return dataclasses.replace(group, rank=0, world_size=1, group=subs[group.rank])


def mesh_shape(group) -> tuple:
    """``(num_shards, num_feat_shards)`` of a ``DataGroup`` or a ``Mesh2D``."""
    if isinstance(group, Mesh2D):
        return group.num_shards, group.num_feat_shards
    return group.world_size, 1


def sub_mesh(mesh, shape) -> object:
    """The mesh of ``shape`` (num_shards, num_feat_shards) inside the launch
    of ``mesh``: ``mesh`` itself; its data axis (``n x 1``, a ``DataGroup``:
    the ranks of one feature block); or its feature axis over a one-rank
    data axis (``1 x k``: the ranks of one query block, each such block
    running the job on all the data).  Every rank makes every rank's
    one-rank group."""
    shape = tuple(shape)
    if not isinstance(mesh, Mesh2D) or shape == mesh_shape(mesh):
        if shape != mesh_shape(mesh):
            raise ValueError(f"no {shape} mesh inside a {mesh_shape(mesh)} launch")
        return mesh
    if shape == (mesh.num_shards, 1):
        return mesh.data
    if shape == (1, mesh.num_feat_shards):
        return Mesh2D(world=mesh.feat, data=solo_group(mesh.world), feat=mesh.feat)
    raise ValueError(f"no {shape} mesh inside a {mesh_shape(mesh)} launch")


def _cleaver(kwargs: dict):
    """A ``Cleaver`` from its keyword arguments, ``line_search`` given as the
    ``LineSearch``'s own (or None)."""
    from quickrank_tpu_torch.learning import LineSearch
    from quickrank_tpu_torch.optimization import Cleaver

    kw = dict(kwargs)
    ls = kw.pop("line_search", None)
    return Cleaver(line_search=LineSearch(**ls) if ls is not None else None, **kw)


def _learner(spec: dict):
    """``spec["learner"](**spec["kwargs"])``; a MetaCleaver's kwargs name its
    learner as a spec (``ltr_algo``) and its Cleaver's kwargs (``cleaver``)."""
    from quickrank_tpu_torch import learning

    kw = dict(spec.get("kwargs", {}))
    if spec["learner"] == "MetaCleaver":
        kw["ltr_algo"] = _learner(kw["ltr_algo"])
        kw["cleaver"] = _cleaver(kw["cleaver"])
    return getattr(learning, spec["learner"])(**kw)


def _reset_counters():
    """Zero the collectives and the kernels' launch counters."""
    from quickrank_tpu_torch.ops import (
        kernel_histogram,
        kernel_partition,
        kernel_qs,
        kernel_query_sum,
    )
    from quickrank_tpu_torch.parallel import mesh

    for counter in (mesh.COLLECTIVES, kernel_histogram.LAUNCHES, kernel_partition.LAUNCHES):
        for k in counter:
            counter[k] = type(counter[k])(0)
    kernel_query_sum.LAUNCHES = kernel_qs.LAUNCHES = kernel_qs.PARTIAL_LAUNCHES = 0


def _counters() -> dict:
    """The collectives and the kernels' launches since :func:`_reset_counters`."""
    from quickrank_tpu_torch.ops import (
        kernel_histogram,
        kernel_partition,
        kernel_qs,
        kernel_query_sum,
    )
    from quickrank_tpu_torch.parallel import mesh

    return {"collectives": dict(mesh.COLLECTIVES),
            "launches": {**kernel_histogram.LAUNCHES, **kernel_partition.LAUNCHES,
                         "query_sum": kernel_query_sum.LAUNCHES,
                         "qs_score": kernel_qs.LAUNCHES,
                         "qs_partial": kernel_qs.PARTIAL_LAUNCHES}}


def _data(spec: dict, group: DataGroup, nthresholds: int, cache: Optional[dict]):
    """This rank's ``TrainData`` of ``spec["train"]`` and the valid
    ``Dataset``, kept in ``cache`` across the jobs of one launch."""
    from quickrank_tpu_torch.learning.mart import TrainData

    cache = {} if cache is None else cache
    key = (spec["train"], nthresholds, mesh_shape(group))
    if key not in cache:
        cache[key] = TrainData.build(load_dataset(spec["train"]), nthresholds, group=group)
    vkey = ("valid", spec.get("valid"))
    if vkey not in cache:
        cache[vkey] = load_dataset(spec.get("valid"))
    return cache[key], cache[vkey]


@contextlib.contextmanager
def k4_timed(on: bool = True):
    """With ``on``, every K4 launch (``kernel_histogram.node_histogram_int``,
    which every K4 entry goes through) between two CUDA events: yields the
    list of event pairs it fills, else None."""
    if not on:
        yield None
        return
    from quickrank_tpu_torch.ops import kernel_histogram

    events = []
    k4 = kernel_histogram.node_histogram_int

    def timed(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = k4(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    kernel_histogram.node_histogram_int = timed
    try:
        yield events
    finally:
        kernel_histogram.node_histogram_int = k4


def train_rank(group: DataGroup, spec: dict, cache: Optional[dict] = None) -> dict:
    """Train ``spec["learner"](**spec["kwargs"])`` on this rank's block of
    ``spec["train"]`` (validated on ``spec.get("valid")``) for
    ``spec.get("metric", "NDCG@10")``; with ``spec["grouped"] = False`` the
    same learner trains on the block alone, with no collective, on the
    rank's device (a one-rank launch: the unsharded run); with
    ``spec["solo"]`` it trains on all of ``spec["train"]`` in a one-rank
    group of this rank alone (:func:`solo_group`).  Returns the history,
    the model (trees, weak rankers, or the weights of a linear ranker), the
    kernels' launches and the collectives issued (calls, bytes,
    seconds)."""
    from quickrank_tpu_torch.learning.mart import Mart
    from quickrank_tpu_torch.metrics.metrics import metric_factory

    model = _learner(spec)
    grouped = spec.get("grouped", True)
    if spec.get("solo"):
        group = solo_group(group)
    if spec.get("mesh"):
        group = sub_mesh(group, spec["mesh"])
    if isinstance(model, Mart):
        tr, valid = _data(spec, group, model.nthresholds, cache)
        if not grouped:
            tr = dataclasses.replace(tr, group=None)
    else:
        tr, valid = load_dataset(spec["train"]), load_dataset(spec.get("valid"))
    _reset_counters()
    with k4_timed(spec.get("k4_ms", False)) as k4_events:
        hist = model.learn(tr, valid, metric_factory(spec.get("metric", "NDCG@10")),
                           verbose=False, device=group.device, mesh=group if grouped else None)
    keep = ("train", "valid", "best_iteration", "iter_seconds", "init_seconds",
            "dropped", "rescored", "epoch_seconds", "iteration_seconds", "iterations")
    out = {"rank": group.rank, "history": {k: hist[k] for k in keep if k in hist},
           **_counters()}
    if k4_events is not None:
        torch.cuda.synchronize(group.device)
        out["k4_ms"] = sum(a.elapsed_time(b) for a, b in k4_events)
    if hasattr(model, "best_weights"):
        out["weights"] = model.get_weights()
    else:
        out["trees"] = ensemble_arrays(getattr(model, "ltr_algo", model))
    return out


def optimize_rank(group: DataGroup, spec: dict, cache: Optional[dict] = None) -> dict:
    """Cleaver (``spec["cleaver"]``, :func:`_cleaver`'s kwargs) on the model
    saved at ``spec["model"]``, on this rank's block of ``spec["train"]``
    and ``spec.get("valid")`` (``spec["grouped"] = False``: on the whole
    folds, with no collective).  Returns the pruned slots, the metrics, the
    weights and the collectives."""
    from quickrank_tpu_torch.learning.base import LTRAlgorithm
    from quickrank_tpu_torch.metrics.metrics import metric_factory

    grouped = spec.get("grouped", True)
    if spec.get("mesh"):
        group = sub_mesh(group, spec["mesh"])
    cleaver = _cleaver(spec["cleaver"])
    _reset_counters()
    info = cleaver.optimize(LTRAlgorithm.load(spec["model"]), load_dataset(spec["train"]),
                            load_dataset(spec.get("valid")),
                            metric_factory(spec.get("metric", "NDCG@10")), verbose=False,
                            device=group.device, mesh=group if grouped else None)
    return {"rank": group.rank, "info": info, "weights": cleaver.weights_, **_counters()}


def grow_rank(group: DataGroup, spec: dict, cache: Optional[dict] = None) -> list:
    """For each (gradient, weight) pair of ``spec["gradients"]`` (an
    ``.npz`` with ``grad`` and ``weight`` ``[T, num_docs_padded]`` in
    ``shard_and_pad(train, world_size)``'s stacked layout), grow one tree on
    this rank's block through ``spec["learner"]``'s grower, as its boosting
    step would (every doc in the sample), and fill its leaves; returns each
    tree's fields and this rank's doc-to-node assignment."""
    from quickrank_tpu_torch.trees.grow import leaf_outputs

    model = _learner(spec)
    if spec.get("mesh"):
        group = sub_mesh(group, spec["mesh"])
    tr, _ = _data(spec, group, model.nthresholds, cache)
    cfg = model._grow_config(tr.num_bins, tr.num_real_features, tr.num_docs)
    n = tr.padded.num_docs_padded
    block = data_group(group).rank
    rows = slice(block * n, (block + 1) * n)
    with np.load(spec["gradients"]) as z:
        grads, weights = z["grad"][:, rows], z["weight"][:, rows]
    dev = tr.step.binned.device
    out = []
    for m in range(grads.shape[0]):
        g = torch.from_numpy(grads[m]).to(dev)
        w = torch.from_numpy(weights[m]).to(dev) if model._newton else None
        smask = tr.step.doc_mask
        tree, node, done = model._fit_and_assign(tr, g, smask, cfg,
                                                 model._generator(m, 1), weights=w)
        if not done:
            tree = leaf_outputs(tree, node, g, smask, weights=w, group=tr.group,
                                num_docs=cfg.num_docs)
        out.append({"tree": {k: v.cpu().numpy() for k, v in vars(tree).items()
                             if isinstance(v, torch.Tensor)},
                    "node": node.cpu().numpy()})
    return out


def multihost_rank(group: DataGroup, spec: dict, cache: Optional[dict] = None) -> dict:
    """:func:`train_rank` through the multi-host data path: this rank keeps
    only its ``process_query_block`` of ``spec["train"]`` (its data axis's,
    under a 2-D mesh) and builds its ``TrainData`` with
    ``build_train_data_multihost`` (with ``spec.get("thresholds")`` as given,
    else the merged tables)."""
    from quickrank_tpu_torch.metrics.metrics import metric_factory
    from quickrank_tpu_torch.parallel.multihost import (
        build_train_data_multihost,
        process_query_block,
    )

    model = _learner(spec)
    if spec.get("mesh"):
        group = sub_mesh(group, spec["mesh"])
    data = data_group(group)
    local = process_query_block(load_dataset(spec["train"]), data.world_size, data.rank)
    td = build_train_data_multihost(local, group, model.nthresholds,
                                    thresholds=spec.get("thresholds"))
    hist = model.learn(td, load_dataset(spec.get("valid")),
                       metric_factory(spec.get("metric", "NDCG@10")), verbose=False,
                       mesh=group)
    return {"rank": group.rank, "history": {k: hist[k] for k in ("train", "valid")},
            "trees": ensemble_arrays(model), "local_docs": local.num_docs}


def layout_rank(group, spec: dict, cache: Optional[dict] = None) -> dict:
    """This rank's ``TrainData`` of ``spec["train"]`` (tables
    ``spec["thresholds"]``) four ways: from the multi-host path (its
    ``process_query_block`` only) and from ``TrainData.build`` over the whole
    dataset, each under ``group`` and under its data axis alone (``mesh`` /
    ``data``): the step tensors, host tables and block geometry as host
    arrays; under a 2-D mesh also the multi-host path's refusal when the
    ranks of a query block pass different blocks (``mismatch``)."""
    from quickrank_tpu_torch.learning.mart import TrainData
    from quickrank_tpu_torch.parallel.multihost import (
        build_train_data_multihost,
        process_query_block,
    )

    if spec.get("mesh"):
        group = sub_mesh(group, spec["mesh"])
    data = data_group(group)
    ds = load_dataset(spec["train"])
    local = process_query_block(ds, data.world_size, data.rank)
    nthr, thr = spec["nthresholds"], spec["thresholds"]
    out = {}
    for where, g in (("mesh", group), ("data", data)):
        for name, td in (
                ("multihost", build_train_data_multihost(local, g, nthr, thresholds=thr)),
                ("whole", TrainData.build(ds, nthr, thresholds=thr, group=g))):
            lay = {k: getattr(td.step, k).cpu().numpy() for k in
                   ("binned", "labels", "doc_mask", "doc_ids", "nvalid", "thresholds")}
            lay.update(host_thresholds=td.thresholds, num_docs=td.num_docs,
                       feat=(td.feat.lo, td.feat.width) if td.feat is not None else None)
            out[(name, where)] = lay
    if data is not group:
        # the ranks of a query block must load the same block: here each
        # loads another, which every rank refuses alike
        try:
            build_train_data_multihost(
                process_query_block(ds, data.world_size,
                                    (data.rank + group.feat.rank) % data.world_size),
                group, nthr, thresholds=thr)
            out["mismatch"] = None
        except ValueError as e:
            out["mismatch"] = str(e)
    return out


def descend_rank(group, spec: dict, cache: Optional[dict] = None) -> dict:
    """The trees ``spec["slots"]`` of the model saved at ``spec["model"]``,
    weighted by ``spec["weights"]``, summed over this rank's rows of
    ``spec["train"]``: by the owners' node tests over this rank's feature
    block (``ops/scoring.py::delta_owned``, the DART delta of a 2-D mesh),
    and by the QuickScorer tables over the data axis's bin matrix (the
    delta of a 1-D group, ``learning/dart.py::DropTable``); ``chunked``:
    the owners' sum again for each all-reduce budget of ``spec["words"]``
    (int64 words a block)."""
    from quickrank_tpu_torch.learning.base import LTRAlgorithm
    from quickrank_tpu_torch.learning.dart import DropTable
    from quickrank_tpu_torch.learning.mart import rebin_ensemble
    from quickrank_tpu_torch.ops.binning import scorer_rows
    from quickrank_tpu_torch.ops.scoring import delta_owned

    if spec.get("mesh"):
        group = sub_mesh(group, spec["mesh"])
    model = LTRAlgorithm.load(spec["model"])
    tr, _ = _data(spec, group, model.nthresholds, cache)
    whole, _ = _data(spec, data_group(group), model.nthresholds, cache)
    ens = rebin_ensemble(model.ensemble, tr.thresholds, force=True).to(tr.step.binned.device)
    md = model._descend_depth()
    owned = delta_owned(tr.step.binned, ens, spec["slots"], spec["weights"], tr.feat, md)
    tables = DropTable(ens, tr.step.binned.device).delta(
        spec["slots"], np.asarray(spec["weights"], np.float32), scorer_rows(whole.step.binned))
    chunked = {w: delta_owned(tr.step.binned, ens, spec["slots"], spec["weights"], tr.feat,
                              md, words=w).cpu().numpy() for w in spec.get("words", ())}
    return {"owned": owned.cpu().numpy(), "qs": tables.cpu().numpy(), "chunked": chunked}


def sample_rank(group: DataGroup, spec: dict, cache: Optional[dict] = None) -> list:
    """Doc subsampling's masks of ``spec["kwargs"]`` (a ``Mart``'s, its
    ``subsample`` among them) on this rank's block of ``spec["train"]``
    (``spec["solo"]``: on all of it, in a one-rank group) for iterations
    ``spec["iterations"]``, over the real docs and over a narrower pool
    (every positive and every third doc, as a presence hook narrows it):
    each mask as the global doc indices it keeps."""
    from quickrank_tpu_torch.learning.mart import Mart

    if spec.get("solo"):
        group = solo_group(group)
    if spec.get("mesh"):
        group = sub_mesh(group, spec["mesh"])
    model = Mart(**spec["kwargs"])
    tr, _ = _data(spec, group, model.nthresholds, cache)
    sd = tr.step
    narrow = sd.doc_mask & ((sd.labels > 0) | (sd.doc_ids % 3 == 0))
    out = []
    for m in spec["iterations"]:
        for pool, narrowed in ((sd.doc_mask, False), (narrow, True)):
            mask = model._sample_mask(tr, m, pool, narrowed=narrowed)
            out.append(sd.doc_ids[mask].cpu().numpy())
    return out


def batch_rank(group: DataGroup, jobs: list) -> list:
    """Run each ``(name, spec)`` of ``jobs`` (a rank entry point of this
    module and its argument) in turn, sharing the data they load; their
    results in order."""
    cache: dict = {}
    return [globals()[name](group, spec, cache) for name, spec in jobs]


def fail_rank(group: DataGroup, failing: int) -> None:
    """Rank ``failing`` raises; the others wait for it in a collective,
    which only its timeout would end: the launcher must stop them and
    report the failure."""
    if group.rank == failing:
        raise RuntimeError(f"rank {group.rank} fails on purpose")
    group.all_reduce_sum(torch.zeros(1, device=group.device))


def driver_rank(group: DataGroup, params: dict) -> Optional[dict]:
    """``driver.run(params)`` on this rank; rank 0 returns its results
    without the learner object, the others None."""
    from quickrank_tpu_torch import driver

    results = driver.run_rank(params, group)
    if group.rank != 0:
        return None
    return {k: v for k, v in results.items() if k != "algo"}
