"""Host-side dataset container and the padded per-query layout (counterpart
of quickrank_tpu/data/dataset.py: ``Dataset``, ``shard_and_pad`` for one
shard, ``select_columns``, ``pack_doc_values``, ``gather_padded``,
``gather_unpad`` and ``scatter_flat``).

Docs live in one flat ``[num_docs_padded]`` axis, queries contiguous, and
``pad_index`` turns flat per-doc arrays into ``[num_queries, max_docs]``
views with a validity mask.  The JAX package's sort-based ``scatter_padded``
(a TPU workaround for slow gathers) is not carried over: ``gather_padded``
gives the same view bit for bit.  Sharding over several devices is ROADMAP.md
§A item 10."""

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


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class PaddedDataset:
    """One-shard padded layout, the JAX package's ``PaddedDataset`` with
    ``num_shards = 1``.  Tensors are CPU torch tensors; callers move what
    they need to their device.

      features   f32 numpy ``[num_docs_padded, F]`` (padding rows zero)
      labels     f32 ``[num_docs_padded]``
      doc_mask   bool ``[num_docs_padded]`` (False on padding rows)
      pad_index  int64 ``[Q, max_docs]``: row of each (query, slot);
                 padding slots point at the last (dummy) row
      slot_mask  bool ``[Q, max_docs]``;  query_mask bool ``[Q]``
      nvalid     int32 ``[Q]`` docs per query
      orig_index int64 ``[num_docs_padded]`` dataset row of each padded row
                 (-1 on padding rows)
      inv_q, inv_slot  int64 ``[num_docs_padded]`` query and slot of each
                 row (0 on padding rows; gate with doc_mask)
    """

    features: np.ndarray
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


def shard_and_pad(
    ds: Dataset,
    num_shards: int = 1,
    max_docs: Optional[int] = None,
    doc_align: int = 1024,
) -> PaddedDataset:
    """Lay ``ds`` out in the padded format: queries in dataset order, one
    dummy row after the last doc, rows rounded up to ``doc_align`` (the
    JAX package's histogram tile; kept so both packages pad alike)."""
    if num_shards != 1:
        raise NotImplementedError(
            "sharded layouts are not ported to quickrank_tpu_torch yet: "
            "ROADMAP.md §A item 10 (parallel training)"
        )
    counts = ds.docs_per_query()
    dmax = int(max_docs or counts.max())
    if counts.max() > dmax:
        raise ValueError(f"max_docs={dmax} < longest query ({counts.max()})")
    Q = ds.num_queries
    n_loc = _round_up(ds.num_docs + 1, doc_align)
    features = np.zeros((n_loc, ds.num_features), dtype=FEATURE_DTYPE)
    features[: ds.num_docs] = ds.features
    labels = np.zeros((n_loc,), dtype=LABEL_DTYPE)
    labels[: ds.num_docs] = ds.labels
    doc_mask = np.zeros((n_loc,), dtype=bool)
    doc_mask[: ds.num_docs] = True
    orig_index = np.full((n_loc,), -1, dtype=np.int64)
    orig_index[: ds.num_docs] = np.arange(ds.num_docs)
    q_of_doc = np.repeat(np.arange(Q), counts)
    slot_of_doc = np.arange(ds.num_docs) - np.repeat(ds.query_offsets[:-1], counts)
    inv_q = np.zeros((n_loc,), dtype=np.int64)
    inv_q[: ds.num_docs] = q_of_doc
    inv_slot = np.zeros((n_loc,), dtype=np.int64)
    inv_slot[: ds.num_docs] = slot_of_doc
    pad_index = np.full((Q, dmax), n_loc - 1, dtype=np.int64)
    pad_index[q_of_doc, slot_of_doc] = np.arange(ds.num_docs)
    slot_mask = np.zeros((Q, dmax), dtype=bool)
    slot_mask[q_of_doc, slot_of_doc] = True
    t = torch.from_numpy
    return PaddedDataset(
        features=features,
        labels=t(labels),
        doc_mask=t(doc_mask),
        pad_index=t(pad_index),
        slot_mask=t(slot_mask),
        query_mask=torch.ones((Q,), dtype=torch.bool),
        nvalid=t(counts.astype(np.int32)),
        orig_index=t(orig_index),
        inv_q=t(inv_q),
        inv_slot=t(inv_slot),
        num_docs_padded=n_loc,
    )


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
