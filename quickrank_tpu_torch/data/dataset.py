"""Host-side dataset container and the padded per-query layout (counterpart
of quickrank_tpu/data/dataset.py: ``Dataset``, ``shard_and_pad`` for one
shard, ``select_columns``, ``pack_doc_values``, ``gather_padded``,
``gather_unpad`` and ``scatter_flat``).

Docs live in one flat ``[num_docs_padded]`` axis, queries contiguous, and
``pad_index`` turns flat per-doc arrays into ``[num_queries, max_docs]``
views with a validity mask.  The JAX package's sort-based ``scatter_padded``
(a TPU workaround for slow gathers) is not carried over: ``gather_padded``
gives the same view bit for bit.  ``shard_and_pad(ds, num_shards)`` packs
the queries into equal per-shard blocks exactly as the JAX package does; a
rank of a query-sharded group (``parallel/mesh.py``) lays out its own block
alone (``block=rank``), which is that layout's slice."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.types import FEATURE_DTYPE, LABEL_DTYPE, QID_DTYPE


@dataclasses.dataclass
class Dataset:
    """Host-side (numpy) learning-to-rank dataset.

    features: float32 ``[num_docs, num_features]`` (1-based feature ids from
        SVML map to columns ``fid - 1``).
    labels: float32 ``[num_docs]`` relevance judgments.
    query_offsets: int64 ``[num_queries + 1]``: docs of query ``q`` are rows
        ``query_offsets[q]:query_offsets[q+1]``.
    qids: original query identifiers ``[num_queries]``.
    """

    features: np.ndarray
    labels: np.ndarray
    query_offsets: np.ndarray
    qids: np.ndarray
    name: str = ""

    @property
    def num_docs(self) -> int:
        return int(self.features.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.features.shape[1])

    @property
    def num_queries(self) -> int:
        return int(len(self.query_offsets) - 1)

    @property
    def max_docs_per_query(self) -> int:
        return int(np.max(np.diff(self.query_offsets)))

    def docs_per_query(self) -> np.ndarray:
        return np.diff(self.query_offsets).astype(np.int64)

    def query_slice(self, q: int) -> slice:
        return slice(int(self.query_offsets[q]), int(self.query_offsets[q + 1]))

    def validate(self) -> None:
        if self.features.ndim != 2:
            raise ValueError(f"features must be 2-D, got {self.features.shape}")
        if self.labels.shape != (self.features.shape[0],):
            raise ValueError("one label per document required")
        if self.query_offsets[0] != 0 or self.query_offsets[-1] != self.num_docs:
            raise ValueError("query offsets must span [0, num_docs]")
        if not np.all(np.diff(self.query_offsets) > 0):
            raise ValueError("every query must hold at least one document")

    @staticmethod
    def from_arrays(features, labels, qids_per_doc, name: str = "") -> "Dataset":
        """Build from a per-doc qid array: docs with equal consecutive qids
        form a query (Svml::read_horizontal's append semantics)."""
        features = np.ascontiguousarray(features, dtype=FEATURE_DTYPE)
        labels = np.ascontiguousarray(labels, dtype=LABEL_DTYPE)
        qids_per_doc = np.asarray(qids_per_doc)
        boundaries = np.flatnonzero(
            np.concatenate(([True], qids_per_doc[1:] != qids_per_doc[:-1]))
        )
        offsets = np.concatenate((boundaries, [len(qids_per_doc)])).astype(
            QID_DTYPE
        )
        qids = qids_per_doc[boundaries].astype(QID_DTYPE)
        ds = Dataset(features, labels, offsets, qids, name=name)
        ds.validate()
        return ds


@dataclasses.dataclass
class BlockDataset(Dataset):
    """One rank's block of a query-sharded dataset (:func:`rank_block`): its
    own queries' rows, and the geometry every block of the group is laid out
    with, ``dims`` = (queries, rows, longest query) a block
    (:func:`shard_and_pad`'s ``force_dims``)."""

    dims: tuple = (0, 0, 0)


def rank_block(ds: Dataset, num_shards: int, block: int) -> BlockDataset:
    """Shard ``block`` of ``shard_and_pad(ds, num_shards)`` as a dataset of
    its own rows: ``shard_and_pad(rank_block(ds, S, b), force_dims=dims)``
    is ``shard_and_pad(ds, S, block=b)``."""
    counts = ds.docs_per_query()
    groups = assign_queries_to_shards(counts, num_shards)
    dims = (max(len(g) for g in groups),
            _round_up(max(int(counts[g].sum()) for g in groups) + 1, DOC_ALIGN),
            int(counts.max()))
    q0, q1 = groups[block][0], groups[block][-1] + 1
    r0, r1 = int(ds.query_offsets[q0]), int(ds.query_offsets[q1])
    return BlockDataset(ds.features[r0:r1], ds.labels[r0:r1],
                        ds.query_offsets[q0:q1 + 1] - r0, ds.qids[q0:q1],
                        name=ds.name, dims=dims)


def select_columns(ds: Dataset, keep: np.ndarray, name: str = "") -> Dataset:
    """Dataset restricted to the 0-based feature columns ``keep`` (the
    driver's --features selection; Cleaver::filter_dataset,
    cleaver.cc:448-481).  ``keep`` must be in [0, num_features)."""
    keep = np.asarray(keep)
    if keep.size and (keep.min() < 0 or keep.max() >= ds.num_features):
        raise ValueError(
            f"feature selection out of range [0, {ds.num_features}): "
            f"{int(keep.min())}..{int(keep.max())}"
        )
    qids = np.repeat(ds.qids, ds.docs_per_query())
    return Dataset.from_arrays(
        ds.features[:, keep], ds.labels, qids, name=name or ds.name
    )


#: rows a block is rounded up to (the JAX package's histogram tile; kept so
#: that both packages pad alike)
DOC_ALIGN = 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class PaddedDataset:
    """The padded layout (the JAX package's ``PaddedDataset``): ``S``
    shard blocks of equal size stacked on the doc and query axes, or one
    shard's block alone.  Tensors are CPU torch tensors; callers move what
    they need to their device.

      features   f32 numpy ``[S * docs_per_shard, F]`` (padding rows zero);
                 None where the layout was made without it (``features=False``)
      labels     f32 ``[S * docs_per_shard]``
      doc_mask   bool ``[S * docs_per_shard]`` (False on padding rows)
      pad_index  int64 ``[S * queries_per_shard, max_docs]``: row of each
                 (query, slot) inside its shard's block; padding slots point
                 at the block's last (dummy) row
      slot_mask  bool ``[S * Q_s, max_docs]``;  query_mask bool ``[S * Q_s]``
                 (False on padding queries)
      nvalid     int32 ``[S * Q_s]`` docs per query (0 on padding queries)
      orig_index int64 ``[S * docs_per_shard]`` dataset row of each padded
                 row (-1 on padding rows)
      inv_q, inv_slot  int64 ``[S * docs_per_shard]`` query (inside its
                 block) and slot of each row (0 on padding rows; gate with
                 doc_mask)

    With one block the indices are the flat layout's own.  JAX holds the
    index arrays in int32; torch indexes with int64, values equal."""

    features: Optional[np.ndarray]
    labels: torch.Tensor
    doc_mask: torch.Tensor
    pad_index: torch.Tensor
    slot_mask: torch.Tensor
    query_mask: torch.Tensor
    nvalid: torch.Tensor
    orig_index: torch.Tensor
    inv_q: torch.Tensor
    inv_slot: torch.Tensor
    num_docs_padded: int
    num_shards: int = 1
    docs_per_shard: int = 0
    queries_per_shard: int = 0
    max_docs: int = 0


def assign_queries_to_shards(doc_counts: np.ndarray, num_shards: int) -> list:
    """Contiguous groups of queries, one a shard, with roughly equal doc
    counts (queries keep their order and never straddle shards; JAX
    dataset.py:186)."""
    total = int(doc_counts.sum())
    target = total / num_shards
    groups: list = []
    cum = np.cumsum(doc_counts)
    start = 0
    for s in range(num_shards - 1):
        # the first query whose cumulative count reaches (s+1) * target,
        # leaving at least one query for each remaining shard
        bound = int(np.searchsorted(cum, (s + 1) * target))
        remaining_shards = num_shards - s - 1
        bound = min(max(bound, start + 1), len(doc_counts) - remaining_shards)
        groups.append(list(range(start, bound)))
        start = bound
    groups.append(list(range(start, len(doc_counts))))
    return groups


def shard_and_pad(
    ds: Dataset,
    num_shards: int = 1,
    max_docs: Optional[int] = None,
    doc_align: int = DOC_ALIGN,
    block: Optional[int] = None,
    force_dims: Optional[tuple] = None,
    features: bool = True,
) -> PaddedDataset:
    """Lay ``ds`` out in the padded format, the JAX package's layout element
    for element (JAX dataset.py:209): queries packed into ``num_shards``
    contiguous groups of balanced doc counts, every block holding the
    largest group's query count and its doc count plus one dummy row,
    rounded up to ``doc_align`` (the JAX package's histogram tile; kept so
    both packages pad alike).  ``block=s`` lays out shard ``s``'s block
    alone (a rank's own data).  ``force_dims`` = (queries, rows, longest
    query) a block, agreed between processes (``parallel/multihost.py``).
    ``features=False`` lays out the index arrays alone and leaves
    ``features`` None: a caller that bins reads a block's rows from ``ds``
    itself (its real docs are ``ds``'s rows ``orig_index[0]`` on, in order;
    ``learning/mart.py::block_wire``)."""
    counts = ds.docs_per_query()
    if len(counts) < num_shards:
        raise ValueError(f"num_queries={len(counts)} < num_shards={num_shards}")
    dmax = int(max_docs or counts.max())
    if counts.max() > dmax:
        raise ValueError(f"max_docs={dmax} < longest query ({counts.max()})")
    groups = assign_queries_to_shards(counts, num_shards)
    q_loc = max(len(g) for g in groups)
    n_loc = _round_up(max(int(counts[g].sum()) for g in groups) + 1, doc_align)
    if force_dims is not None:
        fq, fn, fd = force_dims
        if fq < q_loc or fn < n_loc or fd < dmax:
            raise ValueError(f"force_dims {force_dims} below local minima "
                             f"{(q_loc, n_loc, dmax)}")
        q_loc, n_loc, dmax = fq, fn, fd
    shards = range(num_shards) if block is None else [block]
    parts = [_pad_block(ds, groups[s], q_loc, n_loc, dmax, features) for s in shards]
    cat = lambda k: np.concatenate([p[k] for p in parts])  # noqa: E731
    t = lambda k: torch.from_numpy(cat(k))  # noqa: E731
    return PaddedDataset(
        features=cat("features") if features else None, labels=t("labels"), doc_mask=t("doc_mask"),
        pad_index=t("pad_index"), slot_mask=t("slot_mask"), query_mask=t("query_mask"),
        nvalid=t("nvalid"), orig_index=t("orig_index"), inv_q=t("inv_q"),
        inv_slot=t("inv_slot"), num_docs_padded=len(parts) * n_loc,
        num_shards=len(parts), docs_per_shard=n_loc, queries_per_shard=q_loc,
        max_docs=dmax,
    )


def _pad_block(ds: Dataset, queries: list, q_loc: int, n_loc: int, dmax: int,
               features: bool) -> dict:
    """One shard's block: ``queries`` (contiguous ids) in dataset order from
    row 0, padded to ``q_loc`` queries and ``n_loc`` rows (the feature rows
    only with ``features``)."""
    counts = ds.docs_per_query()[queries]
    Q = len(queries)
    r0 = int(ds.query_offsets[queries[0]])
    n = int(counts.sum())
    rows = slice(r0, r0 + n)
    out = dict(
        labels=np.zeros((n_loc,), dtype=LABEL_DTYPE),
        doc_mask=np.zeros((n_loc,), dtype=bool),
        orig_index=np.full((n_loc,), -1, dtype=np.int64),
        inv_q=np.zeros((n_loc,), dtype=np.int64),
        inv_slot=np.zeros((n_loc,), dtype=np.int64),
        pad_index=np.full((q_loc, dmax), n_loc - 1, dtype=np.int64),
        slot_mask=np.zeros((q_loc, dmax), dtype=bool),
        query_mask=np.zeros((q_loc,), dtype=bool),
        nvalid=np.zeros((q_loc,), dtype=np.int32),
    )
    if features:
        out["features"] = np.zeros((n_loc, ds.num_features), dtype=FEATURE_DTYPE)
        out["features"][:n] = ds.features[rows]
    out["labels"][:n] = ds.labels[rows]
    out["doc_mask"][:n] = True
    out["orig_index"][:n] = np.arange(r0, r0 + n)
    q_of_doc = np.repeat(np.arange(Q), counts)
    slot_of_doc = np.arange(n) - np.repeat(np.cumsum(counts) - counts, counts)
    out["inv_q"][:n] = q_of_doc
    out["inv_slot"][:n] = slot_of_doc
    out["pad_index"][q_of_doc, slot_of_doc] = np.arange(n)
    out["slot_mask"][q_of_doc, slot_of_doc] = True
    out["query_mask"][:Q] = True
    out["nvalid"][:Q] = counts
    return out


def pack_doc_values(padded: PaddedDataset, values_dataset_order) -> torch.Tensor:
    """Dataset-order per-doc values -> flat padded order (0 on pad rows)."""
    v = torch.as_tensor(values_dataset_order)
    idx = torch.clamp(padded.orig_index, min=0).to(v.device)
    return torch.where(padded.doc_mask.to(v.device), v[idx], 0).to(v.dtype)


def gather_padded(flat, pad_index, slot_mask, fill=0.0):
    """Flat per-doc array -> padded ``[Q, D]`` per-query view."""
    return torch.where(slot_mask, flat[pad_index],
                       torch.as_tensor(fill, dtype=flat.dtype, device=flat.device))


def gather_unpad(padded_vals, inv_q, inv_slot, doc_mask):
    """Padded ``[Q, D, ...]`` per-query values -> flat per-doc array
    (0 on padding rows)."""
    out = padded_vals[inv_q, inv_slot]
    mask = doc_mask.reshape(doc_mask.shape + (1,) * (out.ndim - 1))
    return torch.where(mask, out, 0).to(padded_vals.dtype)


def scatter_flat(padded_vals, pad_index, slot_mask, num_docs: int):
    """Padded ``[Q, D]`` per-query values -> flat ``[num_docs]`` per-doc
    array.  Every real doc sits in exactly one (query, slot); the padding
    slots all land on the dummy row, whose value is the sum of zeros."""
    vals = torch.where(slot_mask, padded_vals, torch.zeros((), dtype=padded_vals.dtype,
                                                           device=padded_vals.device))
    flat = torch.zeros(num_docs, dtype=padded_vals.dtype, device=padded_vals.device)
    return flat.index_add_(0, pad_index.reshape(-1), vals.reshape(-1))
