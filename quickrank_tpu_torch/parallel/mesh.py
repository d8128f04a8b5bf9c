"""Query-sharded data parallelism over ``torch.distributed`` (counterpart of
quickrank_tpu/parallel/mesh.py).

One process is one rank: it holds one shard of the queries (an equal
per-shard block of ``data/dataset.py::shard_and_pad``) and one device, its
card (``cuda:rank``) or the CPU.  The JAX package runs the boosting step
under ``shard_map`` over a 1-D mesh with its collective sites in the
growers; here every rank runs the same Python step on its block, and the
same sites cross ranks through a :class:`DataGroup`:

  1. each node's (feature, bin) split-statistic histogram, and the leaf
     sums (``ops/histogram.py``: the kernels' 64-bit fixed-point sums are
     reduced as integers before they are converted, so the reduced
     histogram is the one a single rank computes over all the docs);
  2. every metric: each rank's per-query values are gathered into global
     query order (:class:`BlockOrder`) and every rank sums them as one rank
     over all the queries would (``learning/mart.py::eval_metric``, the
     linear rankers' and Cleaver's ``Fold``); DART's per-tree contribution
     gathers the docs' values the same way.

Every split, early stop, rollback, dropped set, chosen point and pruned set
is decided from reduced values only, so every rank grows the same trees and
holds the same model.  Nothing else crosses ranks, apart from set-up data
(the block orders, and ``parallel/multihost.py``'s threshold tables).

A group's collectives are :meth:`DataGroup.all_reduce_sum`,
:meth:`DataGroup.all_reduce_max` and :meth:`DataGroup.all_gather`.  NCCL is
the default on CUDA and gloo on the CPU;
gloo on CUDA stages each reduction through the host, and is the only
backend that lets two ranks share one card (NCCL refuses two ranks on one
device).
"""

from __future__ import annotations

import dataclasses
import datetime
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

#: every group's collectives time out after this long, so that a rank that
#: died leaves the others with an error, not a hang
TIMEOUT = datetime.timedelta(seconds=60)

#: collectives issued through any DataGroup of this process: calls, bytes
#: reduced or gathered (this rank's tensor), and host seconds spent in them
#: (for NCCL the enqueue only).  A run that reports them sets them to 0
#: first and reads them after.
COLLECTIVES = {"calls": 0, "bytes": 0, "seconds": 0.0}


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One rank's view of a query-sharded group: its rank, the world size,
    its device and the process group (``None``: the default group).

    ``num_docs`` is the count of real documents over all ranks of the run
    being trained (0 until ``learning/mart.py::TrainData.build`` sets it
    with :meth:`with_num_docs`): the histogram kernels derive their
    fixed-point scale from it, so every rank rounds every doc as one rank
    over all the docs would."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: Optional[object] = None
    num_docs: int = 0

    def with_num_docs(self, num_docs: int) -> "DataGroup":
        return dataclasses.replace(self, num_docs=int(num_docs))

    def _staged(self, t: torch.Tensor, op) -> torch.Tensor:
        """``op`` on ``t`` in place across the ranks; gloo reduces a CUDA
        tensor through a host copy."""
        t0 = time.perf_counter()
        if self.backend == "gloo" and t.device.type != "cpu":
            host = t.cpu()
            dist.all_reduce(host, op=op, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=op, group=self.group)
        COLLECTIVES["calls"] += 1
        COLLECTIVES["bytes"] += t.numel() * t.element_size()
        COLLECTIVES["seconds"] += time.perf_counter() - t0
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, in place (int64 sums wrap mod 2^64)."""
        return self._staged(t, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the ranks, in place."""
        return self._staged(t, dist.ReduceOp.MAX)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[world_size, *t.shape]`` on ``t``'s device: every rank's ``t``
        (the same shape and dtype on every rank), in rank order.  Gloo
        gathers through host copies, NCCL on the group's device."""
        t0 = time.perf_counter()
        t = t.contiguous()
        if self.backend == "gloo":
            src = t.cpu()
            parts = [torch.empty_like(src) for _ in range(self.world_size)]
            dist.all_gather(parts, src, group=self.group)
            out = torch.stack(parts)
        else:
            src = t.to(self.device)
            out = torch.empty((self.world_size,) + tuple(t.shape), dtype=t.dtype,
                              device=self.device)
            dist.all_gather_into_tensor(out, src, group=self.group)
        out = out.to(t.device)
        COLLECTIVES["calls"] += 1
        COLLECTIVES["bytes"] += t.numel() * t.element_size()
        COLLECTIVES["seconds"] += time.perf_counter() - t0
        return out


@dataclasses.dataclass(frozen=True)
class BlockOrder:
    """Where the real entries of every rank's block (its queries, or its
    docs) sit in their global order: rank order, then block order, which is
    the unsharded layout's (``data/dataset.py::shard_and_pad`` assigns
    contiguous queries to the ranks in order, real entries first in each
    block).  ``index`` points into the flattened ``[world_size * n]``
    gather of a per-entry ``[..., n]`` tensor; ``total`` is the sum of the
    per-entry counts it was built from (the real docs, for queries).

    :meth:`gather` is the group's order-free reduction: every rank receives
    the same ``[..., count]`` tensor, the one a single rank holds over all
    the data, and then runs the sum one rank runs over it, so N ranks'
    value is one rank's bit for bit."""

    group: DataGroup
    index: torch.Tensor
    total: int

    @staticmethod
    def build(group: DataGroup, counts: torch.Tensor) -> "BlockOrder":
        """From this rank's per-entry counts ``[n]`` (0 on padding entries:
        ``nvalid`` for queries, ``doc_mask`` for docs), with one gather."""
        every = group.all_gather(counts.to(torch.int64)).reshape(-1)
        index = torch.nonzero(every > 0).squeeze(1)
        return BlockOrder(group, index.to(counts.device), int(every.sum()))

    @property
    def count(self) -> int:
        return int(self.index.numel())

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x [..., n]``, this rank's per-entry values, to ``[..., count]``:
        every rank's real entries in global order (one collective)."""
        g = self.group.all_gather(x)
        return g.movedim(0, -2).reshape(x.shape[:-1] + (-1,)).index_select(-1, self.index)


def _device_of(rank: int, device: str, backend: str, world_size: int,
               one_host: bool) -> torch.device:
    d = torch.device(device)
    if d.type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; use gloo on the CPU")
        return d
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("a CUDA group needs a CUDA device and none is visible")
    if backend == "nccl" and one_host and world_size > count:
        raise ValueError(
            f"a {world_size}-rank NCCL group needs {world_size} CUDA devices, one a "
            f"rank, but {count} are visible; NCCL refuses two ranks on one device "
            "(backend='gloo' lets ranks share a card)"
        )
    return d if d.index is not None else torch.device("cuda", rank % count)


def make_mesh(num_shards: int, rank: int, init_method: str, device: str = "cuda",
              backend: Optional[str] = None, one_host: bool = True) -> DataGroup:
    """Join rank ``rank`` of a ``num_shards``-rank group of processes on this
    host and return its :class:`DataGroup`.  ``init_method`` is where the
    ranks meet: ``file://<path>`` (the launcher's, see ``parallel/launch.py``)
    or ``tcp://host:port``.  ``device`` is "cpu", "cuda" (rank r takes
    ``cuda:r``; with gloo, ``cuda:r % device_count``) or one card
    ("cuda:k").  The backend defaults to NCCL on CUDA and gloo on the CPU;
    on one host NCCL needs a card a rank."""
    backend = backend or ("gloo" if torch.device(device).type == "cpu" else "nccl")
    dev = _device_of(rank, device, backend, num_shards, one_host)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=num_shards,
                            rank=rank, timeout=TIMEOUT)
    return DataGroup(rank=rank, world_size=num_shards, device=dev, backend=backend)


def init_distributed(coordinator_address: str, num_processes: int, process_id: int,
                     device: str = "cuda", backend: Optional[str] = None) -> DataGroup:
    """Multi-host initialization (JAX mesh.py:128): join process
    ``process_id`` of ``num_processes`` through a TCP rendezvous at
    ``coordinator_address`` (``host:port``, served by process 0) and return
    the global data group.  ``device`` names this process's card
    ("cuda:k"; "cuda" takes ``cuda:process_id % device_count``) or "cpu".
    Each process then loads its own query block (``parallel/multihost.py``)."""
    return make_mesh(num_processes, process_id, f"tcp://{coordinator_address}",
                     device=device, backend=backend, one_host=False)


def leave(group: Optional[DataGroup]) -> None:
    """Tear the process group down (a rank's last step)."""
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()


class RowShards:
    """Data-parallel batch scoring in one process (JAX mesh.py:48
    ``score_rows_sharded``): the doc rows of ``feats`` are cut into
    ``len(devices)`` contiguous blocks of equal size (zero rows pad the
    last), and block ``i`` is uploaded once to ``devices[i]`` together with
    ``model``'s tables (``model.device_scorer``).  Scoring has no cross-doc
    coupling, so there is no collective.  A CUDA device beyond
    ``torch.cuda.device_count()`` raises, naming the count."""

    def __init__(self, model, feats: np.ndarray, devices: Sequence):
        from quickrank_tpu_torch.data.dataset import Dataset

        self.devices = [torch.device(d) for d in devices]
        count = torch.cuda.device_count()
        for d in self.devices:
            if d.type == "cuda" and (d.index or 0) >= count:
                raise ValueError(
                    f"scoring over {len(self.devices)} devices needs {d}, but "
                    f"{count} CUDA device(s) are visible"
                )
        feats = np.ascontiguousarray(feats, np.float32)
        self.n = feats.shape[0]
        per = -(-self.n // len(self.devices))
        padded = np.zeros((per * len(self.devices), feats.shape[1]), np.float32)
        padded[: self.n] = feats
        self.parts = []
        for i, d in enumerate(self.devices):
            rows = padded[i * per:(i + 1) * per]
            block = Dataset(rows, np.zeros(per, np.float32), np.array([0, per]),
                            np.zeros(1, np.int64))
            self.parts.append(model.device_scorer(block, d))

    def launch(self) -> list:
        """Score every block on its device; the outputs stay there."""
        return [fn(x) for fn, x in self.parts]

    def synchronize(self) -> None:
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def gather(self, outs: list) -> np.ndarray:
        """Scores in row order, on the host."""
        return torch.cat([o.cpu() for o in outs])[: self.n].numpy()


def score_rows_sharded(model, feats: np.ndarray, devices: Sequence) -> np.ndarray:
    """Scores of ``feats``' rows, block ``i`` scored on ``devices[i]``
    (:class:`RowShards`)."""
    shards = RowShards(model, feats, devices)
    return shards.gather(shards.launch())
