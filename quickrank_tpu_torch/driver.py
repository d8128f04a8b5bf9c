"""Driver: training, model save and testing from one flat parameter dict
(counterpart of quickrank_tpu/driver.py, after ``Driver::run``,
src/driver/driver.cc:45-226).

Phases: build the algorithm (factory, with model-in / restart-train
handling), load the datasets, restrict them to ``--features``, train, save
the model, test (with an optional scores file).  Everything runs on
``params["device"]`` (the CUDA card unless it says "cpu").  ``--detailed``
writes the test set's per-tree scores as an SVML file.  The phases whose
modules are not ported (the optimizer, meta algorithms, sharded training, the
device trace and code generation) raise ``NotImplementedError`` naming their
ROADMAP.md item.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import (
    Dataset,
    pack_doc_values,
    select_columns,
    shard_and_pad,
)
from quickrank_tpu_torch.data.svml import read_svml, write_svml
from quickrank_tpu_torch.learning.base import resolve_device
from quickrank_tpu_torch.learning.factory import ltr_algorithm_factory
from quickrank_tpu_torch.metrics.metrics import metric_factory

_OPT_ITEM = "§A item 8 (Cleaver)"
_CLI_ITEM = "§A item 9 (CLIs and export)"
_PARALLEL_ITEM = "§A item 10 (parallel training)"
#: parameters whose phases are not ported: name -> ROADMAP.md item
UNPORTED = {
    "opt_algo": _OPT_ITEM, "opt_method": _OPT_ITEM, "opt_model": _OPT_ITEM,
    "opt_algo_model": _OPT_ITEM, "opt_model_out": _OPT_ITEM,
    "with_line_search": _OPT_ITEM, "line_search_model": _OPT_ITEM,
    "train_partial": _OPT_ITEM, "valid_partial": _OPT_ITEM,
    "meta_algo": "§A item 7 (other learners: MetaCleaver)",
    "num_shards": _PARALLEL_ITEM, "num_feat_shards": _PARALLEL_ITEM,
    "trace": _CLI_ITEM, "code_file": _CLI_ITEM, "model_file": _CLI_ITEM,
}


def load_dataset(path: str, verbose: bool = True) -> Dataset:
    """Driver::load_dataset (driver.cc:387-409)."""
    t0 = time.time()
    ds = read_svml(path)
    if verbose:
        print(
            f"# reading dataset {path}: {ds.num_docs} docs, "
            f"{ds.num_queries} queries, {ds.num_features} features "
            f"({time.time() - t0:.2f} s)"
        )
    return ds


def _read_feature_file(path: str) -> np.ndarray:
    """1-based feature ids, one per line ('#' comments allowed) -> 0-based."""
    ids = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                ids.append(int(line))
    if not ids:
        raise ValueError(f"{path}: empty feature file")
    if min(ids) < 1:
        # '0' is almost always a 0-based/1-based confusion; as a Python
        # index it would select the last column without an error
        raise ValueError(
            f"{path}: feature ids are 1-based (svml convention); got "
            f"{min(ids)}"
        )
    return np.asarray(sorted(set(ids)), np.int64) - 1


def _model_max_feature(algo):
    """Highest feature id a loaded model reads, or None when unknown: the
    --features compatibility check (ids are selection-local for models
    trained under --features)."""
    ens = getattr(algo, "ensemble", None)
    if ens is None or not ens.num_trees:
        return None
    h = ens.live().numpy()
    vals = h["feature"][~h["is_leaf"] & (h["feature"] >= 0)]
    return int(vals.max()) if vals.size else None


def _refuse_unported(p: dict) -> None:
    for name, item in UNPORTED.items():
        if p.get(name):
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported to "
                f"quickrank_tpu_torch yet: ROADMAP.md {item}"
            )


def run(params: dict) -> dict:
    """The full pipeline from a flat parameter dict.  Every phase is
    wall-clocked into ``results["timings"]`` (the reference's phase prints,
    mart.cc:216-258 / driver.cc:239-246)."""
    p = params
    _refuse_unported(p)
    device = resolve_device(p.get("device"))
    timings: dict = {}
    results: dict = {"timings": timings}
    verbose = not p.get("quiet", False)

    def timed(name, t0):
        timings[name] = timings.get(name, 0.0) + time.time() - t0

    train_metric = metric_factory(p.get("train_metric", "NDCG"), p.get("train_cutoff", 10))
    test_metric = metric_factory(p.get("test_metric", "NDCG"), p.get("test_cutoff", 10))

    rest = {k: v for k, v in p.items()
            if k not in ("algo", "model_in", "restart_train", "device")}
    algo = ltr_algorithm_factory(
        algo=p.get("algo", "LAMBDAMART"), model_in=p.get("model_in"),
        restart_train=p.get("restart_train", False), **rest)

    # -- datasets ------------------------------------------------------------
    t0 = time.time()
    train, valid, test = (load_dataset(p[k], verbose) if p.get(k) else None
                          for k in ("train", "valid", "test"))
    timed("load-data", t0)
    if p.get("features"):
        keep = _read_feature_file(p["features"])
        if p.get("model_in"):
            # a loaded model goes with --features only when it was trained
            # under the same selection (its split ids are compacted to
            # 0..K-1 at train time); ids >= len(keep) mean a wider space,
            # where compacting the columns would misroute every split
            needed = _model_max_feature(algo)
            if needed is not None and needed >= len(keep):
                raise SystemExit(
                    f"--features: the loaded model references feature id "
                    f"{needed} but only {len(keep)} columns are selected — "
                    "it was not trained under this feature selection"
                )
        train, valid, test = (select_columns(ds, keep) if ds is not None else None
                              for ds in (train, valid, test))
        if verbose:
            print(f"# restricted to {len(keep)} features from {p['features']}")

    # -- training phase (driver.cc:228-246) ----------------------------------
    # a model loaded with --model-in trains only under --restart-train, as
    # in the reference driver; otherwise it is only scored
    if (train is not None and not p.get("skip_train", False)
            and (not p.get("model_in") or p.get("restart_train"))):
        # every ported learner trains through Mart.learn, which takes these
        kwargs = {}
        if p.get("partial", 0) and p.get("model_out"):
            kwargs.update(partial_save=int(p["partial"]),
                          output_basename=str(p["model_out"]).removesuffix(".xml"))
        if p.get("restart_train"):
            kwargs["warm_start"] = True
        t0 = time.time()
        results["training"] = algo.learn(train, valid, train_metric, verbose=verbose,
                                         device=device, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timed("train", t0)
        if p.get("model_out"):
            algo.save(p["model_out"])
            if verbose:
                print(f"# model saved to {p['model_out']}")

    # -- testing phase (driver.cc:326-385) -----------------------------------
    if test is not None:
        t0 = time.time()
        scores = algo.score_dataset(test, device=device)
        padded = shard_and_pad(test)
        m = test_metric.evaluate_dataset(
            padded, pack_doc_values(padded, torch.from_numpy(scores)))
        timed("test", t0)
        results["test_metric"] = m
        if verbose:
            print(f"# {test_metric!r} on test data: {m:.4f}")
        if p.get("scores"):
            np.savetxt(p["scores"], scores, fmt="%.15g")
            if verbose:
                print(f"# scores saved to {p['scores']}")
        if p.get("detailed"):
            # per-tree partial scores as an SVML dataset (driver.cc:336-360)
            P = algo.partial_scores_dataset(test, device=device)
            qids = np.repeat(test.qids, test.docs_per_query())
            write_svml(Dataset.from_arrays(P, test.labels, qids), p["detailed"])
            if verbose:
                print(f"# detailed per-tree scores saved to {p['detailed']}")

    if verbose and timings:
        parts = " ".join(f"{k}={v:.2f}s" for k, v in timings.items())
        print(f"# phase timings: {parts}")
    results["algo"] = algo
    return results
