"""SVMLight / LETOR text I/O (counterpart of quickrank_tpu/data/svml.py).

Format per line::

    <label> qid:<qid> <fid>:<value> ... # optional comment

The reader grows the feature space to the largest feature id seen (1-based
ids).  The native C++ parser and writer are used when they build; otherwise
a numpy parser and a Python writer give the same result.  This is a host
parser choice; no device is involved.
"""

from __future__ import annotations

import os
import time

import numpy as np

from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.types import FEATURE_DTYPE, LABEL_DTYPE


def _read_numpy(path: str) -> Dataset:
    labels = []
    qids = []
    rows = []  # list of (fids ndarray, vals ndarray)
    maxfid = 0
    with open(path, "r") as f:
        for line in f:
            hash_pos = line.find("#")
            if hash_pos >= 0:
                line = line[:hash_pos]
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 2 or not parts[1].startswith("qid:"):
                raise ValueError(
                    f"{path}: malformed SVML line (expected '<label> qid:<q> ...'):"
                    f" {' '.join(parts[:3])!r}"
                )
            labels.append(float(parts[0]))
            qids.append(int(parts[1][4:]))
            n = len(parts) - 2
            fids = np.empty(n, dtype=np.int64)
            vals = np.empty(n, dtype=np.float64)
            for i, tok in enumerate(parts[2:]):
                k, _, v = tok.partition(":")
                fids[i] = int(k)
                vals[i] = float(v)
            if n:
                if int(fids.min()) < 1:
                    # SVML feature ids are 1-based; 0 or negative would
                    # silently wrap onto the last column via fids - 1
                    raise ValueError(
                        f"{path}: feature id {int(fids.min())} < 1 in line "
                        f"{len(labels)} (SVML ids are 1-based)"
                    )
                maxfid = max(maxfid, int(fids.max()))
            rows.append((fids, vals))
    num_docs = len(labels)
    if num_docs == 0:
        raise ValueError(f"{path}: no documents found")
    feats = np.zeros((num_docs, maxfid), dtype=FEATURE_DTYPE)
    for r, (fids, vals) in enumerate(rows):
        feats[r, fids - 1] = vals
    return Dataset.from_arrays(
        feats,
        np.asarray(labels, dtype=LABEL_DTYPE),
        np.asarray(qids),
        name=os.path.basename(path),
    )


def read_svml(path: str, verbose: bool = False) -> Dataset:
    """Read an SVML/LETOR file into a :class:`Dataset`."""
    t0 = time.time()
    try:
        from quickrank_tpu_torch.data import _svml_native  # noqa: PLC0415

        ds = _svml_native.read(path)
    except Exception:  # noqa: BLE001 - any native failure: numpy parser
        ds = _read_numpy(path)
    if verbose:
        mb = os.path.getsize(path) / 1e6
        dt = time.time() - t0
        print(
            f"# read {ds.num_docs} docs, {ds.num_queries} queries, "
            f"{ds.num_features} features from {path} "
            f"({mb / max(dt, 1e-9):.1f} MB/s)"
        )
    return ds


def write_svml(ds: Dataset, path: str) -> None:
    """Write a dataset in SVML format, every feature value emitted (dense),
    with 9 significant digits (lossless float32 round trip)."""
    try:
        from quickrank_tpu_torch.data import _svml_native  # noqa: PLC0415

        _svml_native.write(ds, path)
        return
    except Exception:  # noqa: BLE001 - any native failure: Python writer
        pass
    with open(path, "w") as f:
        for q in range(ds.num_queries):
            sl = ds.query_slice(q)
            qid = int(ds.qids[q])
            for r in range(sl.start, sl.stop):
                label = ds.labels[r]
                lab_str = (
                    str(int(label))
                    if float(label).is_integer()
                    else f"{float(label):.9g}"
                )
                feats = " ".join(
                    f"{j + 1}:{ds.features[r, j]:.9g}"
                    for j in range(ds.num_features)
                )
                f.write(f"{lab_str} qid:{qid} {feats}\n")
