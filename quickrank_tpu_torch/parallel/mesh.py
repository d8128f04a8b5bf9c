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

The 2-D data x feature mesh (:func:`make_mesh_2d`, JAX mesh.py:104-126)
adds a second axis: ``num_shards x num_feat_shards`` ranks, rank ``r`` at
``(d, f) = divmod(r, num_feat_shards)``, as JAX reshapes its devices
``(data, feat)`` row-major.  A rank holds query block ``d`` and feature
block ``f`` of the bin matrix.  Its :class:`Mesh2D` holds two
:class:`DataGroup` views: ``data``, the ranks of its feature block (the
histograms, leaf sums, the scale's max bits and every metric gather go
over it: feature ranks hold the same docs), and ``feat``, the ranks of its
query block (split candidates are gathered and routing bits combined over
it, :class:`FeatureShard`).
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
class Mesh2D:
    """One rank's view of a 2-D data x feature mesh: ``world`` (every rank,
    the default group), ``data`` (the ranks that share this rank's feature
    block; its rank is the query block ``d``) and ``feat`` (the ranks that
    share its query block; its rank is the feature block ``f``)."""

    world: DataGroup
    data: DataGroup
    feat: DataGroup

    @property
    def rank(self) -> int:
        return self.world.rank

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def num_shards(self) -> int:
        return self.data.world_size

    @property
    def num_feat_shards(self) -> int:
        return self.feat.world_size


@dataclasses.dataclass(frozen=True)
class FeatureShard:
    """This rank's block of the feature axis of a 2-D mesh, as
    ``learning/mart.py::TrainData.build`` lays it out: global feature
    columns ``[lo, lo + width)`` (``width`` = JAX's ``f_blk``, the padding at
    the global end), behind one *stats column*, a copy of global column 0.
    So a rank's bin block is ``[N, 1 + width]``: the histogram kernels run on
    it as they run on a whole matrix, and every node's (count, sum, sum of
    squares) is read from column 0's histogram on every rank, the values one
    rank reads over all features, bit for bit (a node's deviance decides
    which leaf splits next).  The stats column is never a split candidate.

    The growers' two collectives over ``comm`` (the feature group):
    :meth:`best` gathers each rank's best candidate and takes the global
    first maximum (the lower rank wins a tie: the lower global feature id,
    as one rank's argmax does); :meth:`route` combines the routing bits the
    owners of the split features computed."""

    comm: DataGroup
    width: int

    @property
    def index(self) -> int:
        return self.comm.rank

    @property
    def size(self) -> int:
        return self.comm.world_size

    @property
    def lo(self) -> int:
        return self.index * self.width

    @property
    def global_width(self) -> int:
        return self.width * self.size

    def local_mask(self, global_mask: torch.Tensor) -> torch.Tensor:
        """A mask over the global padded width ``[..., size * width]`` to
        this rank's columns ``[..., 1 + width]`` (False on the stats column)."""
        block = global_mask[..., self.lo:self.lo + self.width]
        off = torch.zeros(block.shape[:-1] + (1,), dtype=torch.bool, device=block.device)
        return torch.cat([off, block], dim=-1)

    def to_global(self, f_local: torch.Tensor) -> torch.Tensor:
        return f_local + (self.lo - 1)

    def local_ids(self, f_global: torch.Tensor) -> torch.Tensor:
        """This rank's column of each global feature id, -1 where another
        rank owns it (or where there is none: a leaf's -1)."""
        rel = f_global.long() - self.lo
        return torch.where((rel >= 0) & (rel < self.width), rel + 1, -1)

    def best(self, has: torch.Tensor, gain: torch.Tensor, f_local: torch.Tensor,
             t: torch.Tensor, *extra: torch.Tensor):
        """The global winner of each of ``m`` local candidates ``[m]`` (or
        0-d): one gather of (has, gain, global feature, bin, *extra) as
        float64, which holds float32 values and ids exactly.  Returns
        ``(has_any, gain, f_global, t, *extra)`` of the first maximum over
        the ranks of the gains of the ranks that have a candidate, each the
        input's shape."""
        cols = [has.double(), torch.where(has, gain.double(), float("-inf")),
                self.to_global(f_local.long()).double(), t.double()]
        cols += [x.double() for x in extra]
        every = self.comm.all_gather(torch.stack(cols, dim=-1))  # [k, ..., c]
        win = torch.argmax(every[..., 1], dim=0)  # the first maximum
        sel = every.gather(0, win[None, ..., None].expand((1,) + every.shape[1:]))[0]
        has_any = every[..., 0].amax(dim=0) > 0
        out = [has_any, sel[..., 1].float(), sel[..., 2].long(), sel[..., 3].long()]
        return tuple(out + [sel[..., 4 + i].to(x.dtype) for i, x in enumerate(extra)])

    def route(self, bits: torch.Tensor) -> torch.Tensor:
        """The OR over the feature group of each rank's routing bits (a doc's
        bit is set only by the owner of its split feature): one all-reduce
        max of uint8."""
        return self.comm.all_reduce_max(bits.to(torch.uint8)) > 0


@dataclasses.dataclass(frozen=True)
class BlockOrder:
    """Where the real entries of every rank's block (its queries, or its
    docs) sit in their global order: rank order, then block order, which is
    the unsharded layout's (``data/dataset.py::shard_and_pad`` assigns
    contiguous queries to the ranks in order, real entries first in each
    block).  ``index`` points into the flattened ``[world_size * n]``
    gather of a per-entry ``[..., n]`` tensor; ``total`` is the sum of the
    per-entry counts it was built from (the real docs, for queries);
    ``first`` is the global position of this rank's first real entry (the
    real entries of the ranks before it) and ``before`` the sum of their
    counts (for queries: the global index of this rank's first real doc).

    :meth:`gather` is the group's order-free reduction: every rank receives
    the same ``[..., count]`` tensor, the one a single rank holds over all
    the data, and then runs the sum one rank runs over it, so N ranks'
    value is one rank's bit for bit."""

    group: DataGroup
    index: torch.Tensor
    total: int
    first: int = 0
    before: int = 0

    @staticmethod
    def build(group: DataGroup, counts: torch.Tensor) -> "BlockOrder":
        """From this rank's per-entry counts ``[n]`` (0 on padding entries:
        ``nvalid`` for queries, ``doc_mask`` for docs), with one gather."""
        every = group.all_gather(counts.to(torch.int64))
        earlier = every[:group.rank]
        flat = every.reshape(-1)
        index = torch.nonzero(flat > 0).squeeze(1)
        return BlockOrder(group, index.to(counts.device), int(flat.sum()),
                          int((earlier > 0).sum()), int(earlier.sum()))

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


def make_mesh_2d(num_shards: int, num_feat_shards: int, rank: int, init_method: str,
                 device: str = "cuda", backend: Optional[str] = None,
                 one_host: bool = True) -> Mesh2D:
    """Join rank ``rank`` of a ``num_shards * num_feat_shards``-rank world
    (:func:`make_mesh`'s arguments) and return its :class:`Mesh2D`: rank
    ``r`` is ``(d, f) = divmod(r, num_feat_shards)`` (JAX mesh.py:124).
    Every rank builds every subgroup, in the same order
    (``torch.distributed.new_group`` is collective)."""
    n, k = int(num_shards), int(num_feat_shards)
    world = make_mesh(n * k, rank, init_method, device=device, backend=backend,
                      one_host=one_host)
    d, f = divmod(rank, k)
    data = [dist.new_group([dd * k + ff for dd in range(n)], backend=world.backend,
                           timeout=TIMEOUT) for ff in range(k)]
    feat = [dist.new_group([dd * k + ff for ff in range(k)], backend=world.backend,
                           timeout=TIMEOUT) for dd in range(n)]
    return Mesh2D(world=world,
                  data=dataclasses.replace(world, rank=d, world_size=n, group=data[f]),
                  feat=dataclasses.replace(world, rank=f, world_size=k, group=feat[d]))


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


def init_distributed_2d(coordinator_address: str, num_shards: int, num_feat_shards: int,
                        process_id: int, device: str = "cuda",
                        backend: Optional[str] = None) -> Mesh2D:
    """:func:`init_distributed` of a 2-D mesh (JAX multihost.py:136-190):
    process ``process_id`` of ``num_shards * num_feat_shards`` joins its
    :class:`Mesh2D`.  Each host runs whole data rows: the
    ``num_feat_shards`` processes of a query block load the same block
    (``parallel/multihost.py`` checks it), so the feature collectives stay
    on one host."""
    return make_mesh_2d(num_shards, num_feat_shards, process_id,
                        f"tcp://{coordinator_address}", device=device, backend=backend,
                        one_host=False)


def data_group(mesh) -> Optional[DataGroup]:
    """The query-sharded group of ``mesh``: a :class:`DataGroup` itself, or
    a :class:`Mesh2D`'s data axis; None for None."""
    return mesh.data if isinstance(mesh, Mesh2D) else mesh


def feature_sharded(mesh) -> bool:
    """Whether ``mesh`` shards the feature axis over more than one rank."""
    return isinstance(mesh, Mesh2D) and mesh.num_feat_shards > 1


def leave(group: Optional[DataGroup]) -> None:
    """Tear the process group down (a rank's last step)."""
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()


def row_block(feats: np.ndarray, parts: int, i: int):
    """Block ``i`` of ``feats``' doc rows cut into ``parts`` contiguous
    blocks of equal size (zero rows pad the last), as a one-query
    ``Dataset`` for a model's scorer."""
    from quickrank_tpu_torch.data.dataset import Dataset

    n = feats.shape[0]
    per = -(-n // parts)
    rows = np.zeros((per, feats.shape[1]), np.float32)
    mine = feats[i * per:(i + 1) * per]
    rows[:mine.shape[0]] = mine
    return Dataset(rows, np.zeros(per, np.float32), np.array([0, per]),
                   np.zeros(1, np.int64))


class RowShards:
    """Data-parallel batch scoring in one process (JAX mesh.py:48
    ``score_rows_sharded``): the doc rows of ``feats`` are cut into
    ``len(devices)`` contiguous blocks of equal size (zero rows pad the
    last), and block ``i`` is uploaded once to ``devices[i]`` together with
    ``model``'s tables (``model.device_scorer``).  Scoring has no cross-doc
    coupling, so there is no collective.  A CUDA device beyond
    ``torch.cuda.device_count()`` raises, naming the count."""

    def __init__(self, model, feats: np.ndarray, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        count = torch.cuda.device_count()
        for d in self.devices:
            if d.type == "cuda" and (d.index or 0) >= count:
                raise ValueError(
                    f"scoring over {len(self.devices)} devices needs {d}, but "
                    f"{count} CUDA device(s) are visible"
                )
        self.n = feats.shape[0]
        self.parts = [model.device_scorer(row_block(feats, len(self.devices), i), d)
                      for i, d in enumerate(self.devices)]

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


def score_rows_group(model, feats: np.ndarray, group) -> np.ndarray:
    """Scores of ``feats``' rows under a query-sharded group (JAX driver.py:
    337-341): every rank scores its :func:`row_block` on its own device, and
    one gather gives every rank all the scores in row order.  Scoring has no
    cross-doc coupling, so they are one device's scores bit for bit.  A 2-D
    mesh scores over all its ranks as one flat doc axis (its ``world``)."""
    if isinstance(group, Mesh2D):
        group = group.world
    n = feats.shape[0]
    block = row_block(feats, group.world_size, group.rank)
    mine = torch.from_numpy(np.ascontiguousarray(model.score_dataset(block, group.device)))
    return group.all_gather(mine).reshape(-1)[:n].numpy()
