"""Multi-host data path (counterpart of quickrank_tpu/parallel/multihost.py):
each process loads only its own query block and agrees with the others, once
at set-up, on the padded shard geometry and the threshold tables.

  * ``process_query_block`` cuts a dataset into contiguous query blocks
    balanced by cumulative doc count (pre-split per-host SVML files skip it);
  * ``merge_threshold_candidates`` merges the processes' candidate tables
    per feature and re-quantiles them (the standard distributed-binning
    approximation, exact when the union has at most B distinct values);
  * ``global_thresholds`` builds the local tables, gathers them
    (``DataGroup.all_gather``, CPU tensors) and merges them, so every
    process holds the same tables;
  * ``build_train_data_multihost`` lays the process's block out with the
    agreed geometry and tables: the ``TrainData`` that ``Mart.learn(...,
    mesh=group)`` takes in place of a dataset.

Training then runs the unchanged sharded step; its collectives are those of
``parallel/mesh.py``.
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import Dataset, _round_up
from quickrank_tpu_torch.ops.binning import FLT_MAX, build_thresholds
from quickrank_tpu_torch.parallel.mesh import DataGroup


def process_query_block(ds: Dataset, num_processes: int, process_id: int) -> Dataset:
    """Contiguous, doc-count-balanced query block of one process (the split
    policy of ``assign_queries_to_shards``)."""
    counts = ds.docs_per_query()
    if num_processes > len(counts):
        raise ValueError(
            f"process_query_block: {num_processes} processes > {len(counts)} queries — "
            "every process needs at least one whole query"
        )
    cum = np.concatenate([[0], np.cumsum(counts)])
    target = cum[-1] / num_processes
    bounds = [0]
    for pidx in range(1, num_processes):
        b = int(np.searchsorted(cum, pidx * target))
        b = min(max(b, bounds[-1] + 1), len(counts) - (num_processes - pidx))
        bounds.append(b)
    bounds.append(len(counts))
    q0, q1 = bounds[process_id], bounds[process_id + 1]
    sl = slice(int(ds.query_slice(q0).start), int(ds.query_slice(q1 - 1).stop))
    qids_per_doc = np.repeat(ds.qids, counts)[sl]
    return Dataset.from_arrays(ds.features[sl], ds.labels[sl], qids_per_doc,
                               name=f"{ds.name}[proc{process_id}]")


def merge_threshold_candidates(all_thr: np.ndarray) -> np.ndarray:
    """Merge per-process candidate tables ``[P, F, B]`` into one ``[F, B]``
    table: per feature the union of the candidates below the FLT_MAX
    sentinel, ``B - 1`` of them picked at evenly spaced ranks (the union
    repeated at its top when it holds fewer), then the sentinel."""
    all_thr = np.asarray(all_thr)
    _, F, B = all_thr.shape
    out = np.empty((F, B), np.float32)
    for f in range(F):
        cand = np.unique(all_thr[:, f, :].reshape(-1))
        cand = cand[np.isfinite(cand) & (cand < np.float32(FLT_MAX))]
        if len(cand) == 0:  # a constant or empty feature: the sentinel alone
            out[f, :] = np.float32(FLT_MAX)
            continue
        if len(cand) >= B:
            vals = cand[np.linspace(0, len(cand) - 1, B - 1).round().astype(int)]
        else:
            vals = np.pad(cand, (0, B - 1 - len(cand)), mode="edge")
        out[f, : B - 1] = vals
        out[f, B - 1] = np.float32(FLT_MAX)
    return out


def global_thresholds(local_features: np.ndarray, nthresholds: int,
                      group: DataGroup) -> np.ndarray:
    """The same ``[F, B]`` tables on every process, from each process's own
    candidates: local tables, one gather, the deterministic merge."""
    local_thr, _ = build_thresholds(local_features, nthresholds)
    all_thr = group.all_gather(torch.from_numpy(np.ascontiguousarray(local_thr)))
    return merge_threshold_candidates(all_thr.numpy())


def build_train_data_multihost(local_ds: Dataset, group: DataGroup, nthresholds: int,
                               thresholds: Optional[np.ndarray] = None):
    """This process's ``TrainData`` over its own query block ``local_ds``:
    the processes agree on the padded geometry (the largest block's queries,
    padded rows and longest query; one gather) and on the threshold tables
    (``thresholds`` as given, the same on every process, or
    :func:`global_thresholds`).  Mart-family learners take it in place of a
    dataset (``learn(train_data, ..., mesh=group)``)."""
    from quickrank_tpu_torch.learning.mart import TrainData

    counts = local_ds.docs_per_query()
    local = torch.tensor([len(counts), _round_up(int(counts.sum()) + 1, 1024),
                          int(counts.max()), local_ds.num_docs], dtype=torch.int64)
    dims = group.all_gather(local)
    force = tuple(int(x) for x in dims[:, :3].max(dim=0).values)
    if thresholds is None:
        thresholds = global_thresholds(local_ds.features, nthresholds, group)
    else:
        # tables given by the callers must be the same bytes everywhere, or
        # the ranks would grow different trees without an error
        digest = zlib.crc32(np.ascontiguousarray(thresholds, np.float32).tobytes())
        seen = group.all_gather(torch.tensor([digest], dtype=torch.int64))
        if not bool((seen == seen[0]).all()):
            raise ValueError(
                "build_train_data_multihost: the threshold tables differ between "
                f"processes (crc32 per process: {seen[:, 0].tolist()}); pass the same "
                "tables everywhere or let global_thresholds derive them"
            )
    return TrainData.build(local_ds, nthresholds, thresholds=thresholds,
                           group=group, force_dims=force, num_docs=int(dims[:, 3].sum()))
