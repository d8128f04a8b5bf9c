"""Host-side dataset container (counterpart of quickrank_tpu/data/dataset.py's
``Dataset``; the padded device layout waits for the training port)."""

from __future__ import annotations

import dataclasses

import numpy as np

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
