"""Rank entry points for ``parallel/launch.py::run_ranks``: each runs in one
rank of a group and returns what the launcher gathers.

  * :func:`driver_rank`: quicklearn's pipeline (``driver.run``) under the
    group; rank 0 alone prints, writes the model and scores ``--test``;
  * :func:`train_rank`: one learner trained from a spec (``chip_smoke.py``,
    the parallel tests): the Mart family and DART on a shared ``TrainData``,
    the linear rankers and MetaCleaver on the datasets;
  * :func:`optimize_rank`: Cleaver on a saved model;
  * :func:`grow_rank`: one tree a given (gradient, weight) pair through a
    learner's grower, with no boosting loop around it: the harness that
    holds the sharded growers against a reference given the same gradients;
  * :func:`multihost_rank`: the multi-host data path on this host (each
    rank loads only its query block, ``parallel/multihost.py``), then
    training;
  * :func:`batch_rank`: several of the above in one launch;
  * :func:`fail_rank`: one rank raises while the others wait in a
    collective (the launcher's failure path).

Datasets travel as paths of ``.npz`` files (:func:`save_dataset`), so that
large folds are not pickled through the launcher.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.parallel.mesh import DataGroup


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
    and runs)."""
    return model.ensemble.live().numpy()


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
    from quickrank_tpu_torch.ops import kernel_histogram, kernel_qs, kernel_query_sum
    from quickrank_tpu_torch.parallel import mesh

    for counter in (mesh.COLLECTIVES, kernel_histogram.LAUNCHES):
        for k in counter:
            counter[k] = type(counter[k])(0)
    kernel_query_sum.LAUNCHES = kernel_qs.LAUNCHES = kernel_qs.PARTIAL_LAUNCHES = 0


def _counters() -> dict:
    """The collectives and the kernels' launches since :func:`_reset_counters`."""
    from quickrank_tpu_torch.ops import kernel_histogram, kernel_qs, kernel_query_sum
    from quickrank_tpu_torch.parallel import mesh

    return {"collectives": dict(mesh.COLLECTIVES),
            "launches": {**kernel_histogram.LAUNCHES, "query_sum": kernel_query_sum.LAUNCHES,
                         "qs_score": kernel_qs.LAUNCHES,
                         "qs_partial": kernel_qs.PARTIAL_LAUNCHES}}


def _data(spec: dict, group: DataGroup, nthresholds: int, cache: Optional[dict]):
    """This rank's ``TrainData`` of ``spec["train"]`` and the valid
    ``Dataset``, kept in ``cache`` across the jobs of one launch."""
    from quickrank_tpu_torch.learning.mart import TrainData

    cache = {} if cache is None else cache
    key = (spec["train"], nthresholds)
    if key not in cache:
        cache[key] = TrainData.build(load_dataset(spec["train"]), nthresholds, group=group)
    vkey = ("valid", spec.get("valid"))
    if vkey not in cache:
        cache[vkey] = load_dataset(spec.get("valid"))
    return cache[key], cache[vkey]


def train_rank(group: DataGroup, spec: dict, cache: Optional[dict] = None) -> dict:
    """Train ``spec["learner"](**spec["kwargs"])`` on this rank's block of
    ``spec["train"]`` (validated on ``spec.get("valid")``) for
    ``spec.get("metric", "NDCG@10")``; with ``spec["grouped"] = False`` the
    same learner trains on the block alone, with no collective, on the
    rank's device (a one-rank launch: the unsharded run).  Returns the
    history, the model (trees, or the weights of a linear ranker), the
    histogram kernels' launches and the collectives issued (calls, bytes,
    seconds)."""
    from quickrank_tpu_torch.learning.mart import Mart
    from quickrank_tpu_torch.metrics.metrics import metric_factory

    model = _learner(spec)
    grouped = spec.get("grouped", True)
    if isinstance(model, Mart):
        tr, valid = _data(spec, group, model.nthresholds, cache)
        if not grouped:
            tr = dataclasses.replace(tr, group=None)
    else:
        tr, valid = load_dataset(spec["train"]), load_dataset(spec.get("valid"))
    _reset_counters()
    hist = model.learn(tr, valid, metric_factory(spec.get("metric", "NDCG@10")),
                       verbose=False, device=group.device, mesh=group if grouped else None)
    keep = ("train", "valid", "best_iteration", "iter_seconds", "init_seconds",
            "dropped", "epoch_seconds", "iteration_seconds", "iterations")
    out = {"rank": group.rank, "history": {k: hist[k] for k in keep if k in hist},
           **_counters()}
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
    tr, _ = _data(spec, group, model.nthresholds, cache)
    cfg = model._grow_config(tr.num_bins, tr.num_real_features, tr.num_docs)
    n = tr.padded.num_docs_padded
    rows = slice(group.rank * n, (group.rank + 1) * n)
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
            tree = leaf_outputs(tree, node, g, smask, weights=w, group=group,
                                num_docs=cfg.num_docs)
        out.append({"tree": {k: v.cpu().numpy() for k, v in vars(tree).items()
                             if isinstance(v, torch.Tensor)},
                    "node": node.cpu().numpy()})
    return out


def multihost_rank(group: DataGroup, spec: dict, cache: Optional[dict] = None) -> dict:
    """:func:`train_rank` through the multi-host data path: this rank keeps
    only its ``process_query_block`` of ``spec["train"]`` and builds its
    ``TrainData`` with ``build_train_data_multihost`` (with
    ``spec.get("thresholds")`` as given, else the merged tables)."""
    from quickrank_tpu_torch.metrics.metrics import metric_factory
    from quickrank_tpu_torch.parallel.multihost import (
        build_train_data_multihost,
        process_query_block,
    )

    model = _learner(spec)
    local = process_query_block(load_dataset(spec["train"]), group.world_size, group.rank)
    td = build_train_data_multihost(local, group, model.nthresholds,
                                    thresholds=spec.get("thresholds"))
    hist = model.learn(td, load_dataset(spec.get("valid")),
                       metric_factory(spec.get("metric", "NDCG@10")), verbose=False,
                       mesh=group)
    return {"rank": group.rank, "history": {k: hist[k] for k in ("train", "valid")},
            "trees": ensemble_arrays(model), "local_docs": local.num_docs}


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
