"""Driver: training, post-learning optimization, model save and testing
from one flat parameter dict (counterpart of quickrank_tpu/driver.py, after
``Driver::run``, src/driver/driver.cc:45-226).

Phases: build the algorithm (factory, with model-in / restart-train
handling and the --meta-algo wrapping), build the optimizer (or load it
from --opt-model), load the datasets, restrict them to ``--features``,
train, save the model, optimize (Cleaver on the per-tree scores, which
--train-partial / --valid-partial load or write), save the optimizer and
the optimized model, test (with an optional scores file), and translate a
model into standalone scoring code (``--code-file`` from ``--model-file``
with the ``condop``, ``oblivious`` or ``vpred`` generator).  Everything runs
on ``params["device"]`` (the CUDA card unless it says "cpu").  ``--detailed``
writes the test set's per-tree scores as an SVML file; ``--trace DIR``
captures a ``torch.profiler`` trace of the training phase into DIR.

``--num-shards N`` runs query-sharded: the pipeline runs in N spawned ranks
(``parallel/launch.py``), one a device (NCCL, a card a rank; on ``--device
cpu`` gloo ranks on the CPU), each training and optimizing on its block of
the queries; every rank holds the same model.  ``--test`` scoring fans the
doc rows out over the ranks' devices (JAX driver.py:337-341) and gathers the
scores, which equal one device's bit for bit; rank 0 alone prints, writes
the files and evaluates.  ``--num-feat-shards K`` (K > 1) also shards the
feature axis of the growers: ``--num-shards N`` x K ranks of a 2-D data x
feature mesh (JAX driver.py:203-235), whose excluded combinations
(RankBoost, the linear rankers, ``--restart-train``,
``--collapse-leaves-factor``) are refused before anything runs, with JAX's
messages.  ``--generator pt2`` writes the scorer as a ``torch.export``
archive (``io/export.py``); ``--generator stablehlo``, the JAX package's
``jax.export`` artifact, is refused before anything runs, with the reason.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import time
from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import (
    Dataset,
    pack_doc_values,
    select_columns,
    shard_and_pad,
)
from quickrank_tpu_torch.data.svml import read_svml, write_svml
from quickrank_tpu_torch.io.codegen import STABLEHLO_REFUSED
from quickrank_tpu_torch.learning.base import LTRAlgorithm, resolve_device
from quickrank_tpu_torch.learning.factory import ltr_algorithm_factory, meta_factory
from quickrank_tpu_torch.metrics.metrics import metric_factory
from quickrank_tpu_torch.optimization.cleaver import Cleaver
from quickrank_tpu_torch.optimization.factory import optimization_factory
from quickrank_tpu_torch.parallel.mesh import score_rows_group
from quickrank_tpu_torch.utils.profiling import phase_timer, trace

#: the learners that train on a 1-D (data) mesh only (JAX driver.py:213-218)
NO_2D = ("RANKBOOST", "COORDASC", "LINESEARCH")


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
    w = getattr(algo, "best_weights", None)
    if w is not None and len(w):
        return len(w) - 1  # a linear model reads one column per weight
    ens = getattr(algo, "ensemble", None)
    if ens is None or not ens.num_trees:
        return None
    h = ens.live().numpy()
    vals = h["feature"][~h["is_leaf"] & (h["feature"] >= 0)]
    return int(vals.max()) if vals.size else None


def _partial_fold(algo, ds: Optional[Dataset], path: Optional[str], device,
                  verbose: bool, group=None) -> Optional[Dataset]:
    """The per-tree score dataset of one fold: read from ``path`` when it
    exists, else extracted from ``algo`` on ``ds`` and written to ``path``
    when one is given.  Under a group each rank extracts its own block,
    except that rank 0 extracts all of ``ds`` when it writes ``path``."""
    if path and os.path.exists(path):
        return load_dataset(path, verbose)
    if ds is None:
        return None
    lead = group is None or group.rank == 0
    pds = Cleaver.partial_dataset(algo, ds, device, None if path and lead else group)
    if path and lead:
        write_svml(pds, path)
        if verbose:
            print(f"# partial scores saved to {path}")
    return pds


def _refuse_stablehlo(p: dict) -> None:
    if str(p.get("generator") or "").lower() == "stablehlo":
        raise NotImplementedError(f"--generator stablehlo: {STABLEHLO_REFUSED}")


def _refuse_2d(p: dict) -> None:
    """The combinations a 2-D mesh excludes, refused up front with JAX's
    messages (driver.py:203-232; PARITY.md "known exclusions")."""
    algo = str(p.get("algo", "LAMBDAMART")).upper()
    if algo in NO_2D:
        raise NotImplementedError(
            f"--num-feat-shards: {algo} supports 1-D (data) meshes only (PARITY.md "
            "known exclusions)")
    if p.get("restart_train"):
        raise NotImplementedError(
            "--num-feat-shards with --restart-train is not supported (warm starts "
            "need feature-replicated descent; PARITY.md known exclusions)")
    if float(p.get("collapse_leaves_factor", 0) or 0) > 0:
        raise NotImplementedError(
            "--num-feat-shards with --collapse-leaves-factor is not supported "
            "(PARITY.md known exclusions)")


def _learner(p: dict) -> LTRAlgorithm:
    """The learner of ``p`` (built, or loaded with ``--model-in``)."""
    rest = {k: v for k, v in p.items()
            if k not in ("algo", "model_in", "restart_train", "device")}
    return ltr_algorithm_factory(
        algo=p.get("algo", "LAMBDAMART"), model_in=p.get("model_in"),
        restart_train=p.get("restart_train", False), **rest)


def run(params: dict) -> dict:
    """The full pipeline from a flat parameter dict.  Every phase is
    wall-clocked into ``results["timings"]`` (the reference's phase prints,
    mart.cc:216-258 / driver.cc:239-246).  With ``num_shards`` the pipeline
    runs in that many ranks and the results are rank 0's (without the
    learner object); with ``num_feat_shards`` > 1 in ``num_shards`` x
    ``num_feat_shards`` ranks of a 2-D mesh.  ``deadline`` (seconds, no
    flag) bounds their launch."""
    p = params
    _refuse_stablehlo(p)
    shards = int(p.get("num_shards") or 0)
    feat = int(p.get("num_feat_shards") or 0)
    if feat > 1:
        _refuse_2d(p)
    else:
        feat = 1
    if not shards and feat == 1:
        return run_rank(p, None)
    shards = max(shards, 1)
    device = str(p.get("device") or "cuda")
    ranks = shards * feat
    if device != "cpu" and torch.cuda.device_count() < ranks:
        flags = f"--num-shards {shards}" + (f" --num-feat-shards {feat}" if feat > 1 else "")
        raise ValueError(
            f"{flags} on {device} needs {ranks} CUDA devices, one a rank, "
            f"but {torch.cuda.device_count()} are visible (--device cpu runs the ranks "
            "on the CPU)")
    from quickrank_tpu_torch.parallel.launch import run_ranks
    from quickrank_tpu_torch.parallel.workers import driver_rank

    return run_ranks(driver_rank, shards, args=(p,), device=device,
                     deadline=p.get("deadline"), num_feat_shards=feat)[0]


def run_rank(params: dict, group) -> dict:
    """:func:`run`'s pipeline in one process, or in one rank of a group
    (``group``, a ``parallel.DataGroup`` or a ``parallel.mesh.Mesh2D``): the
    rank trains on its block on the group's device, and rank 0 alone
    prints, saves and tests."""
    p = params
    device = group.device if group is not None else resolve_device(p.get("device"))
    lead = group is None or group.rank == 0
    timings: dict = {}
    results: dict = {"timings": timings}
    verbose = not p.get("quiet", False) and lead

    def timed(name):
        return phase_timer(name, sink=timings, verbose=False)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    train_metric = metric_factory(p.get("train_metric", "NDCG"), p.get("train_cutoff", 10))
    test_metric = metric_factory(p.get("test_metric", "NDCG"), p.get("test_cutoff", 10))

    algo = _learner(p)

    meta_algo = p.get("meta_algo")
    optimizer = None
    if p.get("opt_model") and not p.get("opt_algo") and not meta_algo:
        # --opt-model is the optimizer model's input when no --opt-algo asks
        # for a search (optimization_factory.cc:85-92)
        if os.path.exists(p["opt_model"]):
            optimizer = Cleaver.load(p["opt_model"])
            if verbose:
                print(f"# optimizer model loaded from {p['opt_model']}")
    if optimizer is None and (p.get("opt_algo") or meta_algo):
        optimizer = optimization_factory(
            opt_algo=p.get("opt_algo", "EPRUNING"),
            opt_method=p.get("opt_method", "QUALITY_LOSS"),
            # 0.5, the reference's default: half the ensemble (a rate of 1.0
            # would mean one tree, rates >= 1 being counts)
            pruning_rate=p.get("pruning_rate", 0.5),
            with_line_search=p.get("with_line_search", False)
            or bool(p.get("line_search_model")),
            line_search_kwargs=dict(
                num_points=p.get("num_samples", 21),
                window_size=p.get("window_size", 10.0),
                reduction_factor=p.get("reduction_factor", 0.95),
                max_iterations=p.get("max_iterations", 100),
                max_failed_vali=p.get("max_failed_valid", 20),
                adaptive=p.get("adaptive", False),
            ),
            seed=p.get("seed", 0),
        )
        if p.get("line_search_model") and optimizer.line_search is not None:
            optimizer.line_search = LTRAlgorithm.load(p["line_search_model"])

    if meta_algo:
        meta_params = {k: v for k, v in p.items() if k != "meta_algo"}
        algo = meta_factory(meta_algo, algo, optimizer, **meta_params)
        optimizer = None  # the meta algorithm runs it

    # -- datasets ------------------------------------------------------------
    with timed("load-data"):
        train, valid, test = (load_dataset(p[k], verbose) if p.get(k) else None
                              for k in ("train", "valid", "test"))
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
        # optional kwargs are gated on each learner's signature: quicklearn
        # drives every algorithm through the same flags (driver.cc:45-226),
        # and a learner without partial saves or a warm start (the linear
        # rankers, MetaCleaver) ignores them, with a note
        supported = inspect.signature(algo.learn).parameters
        kwargs = {}
        if p.get("partial", 0) and p.get("model_out"):
            kwargs.update(partial_save=int(p["partial"]),
                          output_basename=str(p["model_out"]).removesuffix(".xml"))
        if p.get("restart_train"):
            kwargs["warm_start"] = True
        if group is not None:
            kwargs["mesh"] = group
        dropped = [k for k in kwargs if k not in supported]
        for k in dropped:
            kwargs.pop(k)
        if dropped and verbose:
            print(f"# note: {type(algo).__name__}.learn has no "
                  f"{'/'.join(dropped)} support; ignoring those flags")
        tracer = (trace(p["trace"], cuda=device.type == "cuda") if p.get("trace") and lead
                  else contextlib.nullcontext())
        with tracer as trace_path, timed("train"):
            results["training"] = algo.learn(train, valid, train_metric, verbose=verbose,
                                             device=device, **kwargs)
            sync()
        if trace_path and verbose:
            print(f"# trace of the training phase written to {trace_path}")
        if p.get("model_out") and lead:
            algo.save(p["model_out"])
            if verbose:
                print(f"# model saved to {p['model_out']}")

    # -- optimization phase (driver.cc:248-324) ------------------------------
    if optimizer is not None and (train is not None or p.get("train_partial")):
        # per-tree score datasets: loaded from --train-partial /
        # --valid-partial when the file exists, else extracted (and written
        # when a path is given), driver.cc:270-298
        ptrain = _partial_fold(algo, train, p.get("train_partial"), device, verbose, group)
        pvalid = _partial_fold(algo, valid, p.get("valid_partial"), device, verbose, group)
        with timed("optimize"):
            results["optimization"] = optimizer.optimize(
                algo, train, valid, train_metric, verbose=verbose, ptrain=ptrain,
                pvalid=pvalid, device=device, mesh=group)
            sync()
        if p.get("opt_model") and lead:
            optimizer.save(p["opt_model"])
            if verbose:
                print(f"# optimizer model saved to {p['opt_model']}")
        # --opt-algo-model: the optimized ranker (--opt-model-out is its old
        # name; --model-out otherwise)
        out = p.get("opt_algo_model") or p.get("opt_model_out") or p.get("model_out")
        if out and lead:
            algo.save(out)
            if verbose:
                print(f"# optimized model saved to {out}")

    # -- testing phase (driver.cc:326-385) -----------------------------------
    if test is not None:
        with timed("test"):
            # under a group every rank scores its block of the doc rows
            scores = (algo.score_dataset(test, device=device) if group is None
                      else score_rows_group(algo, test.features, group))
            if lead:
                padded = shard_and_pad(test)
                # float32 as the JAX package evaluates them (linear and
                # RankBoost scores are float64)
                results["test_metric"] = m = test_metric.evaluate_dataset(
                    padded, pack_doc_values(padded, torch.from_numpy(scores).float()))
    if test is not None and lead:
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

    # -- codegen phase (driver.cc:199-223) -----------------------------------
    if p.get("code_file") and p.get("model_file") and lead:
        from quickrank_tpu_torch.io import codegen, export

        generator = p.get("generator", "condop")
        with timed("codegen"):
            model = LTRAlgorithm.load(p["model_file"])
            if generator.lower() == export.GENERATOR_NAME:
                # the scorer as a torch.export archive, not C source
                export.export_scorer(model, path=p["code_file"])
            else:
                code = codegen.generate(model, generator)
                with open(p["code_file"], "w") as f:
                    f.write(code)
        if verbose:
            print(f"# {generator} code saved to {p['code_file']}")

    if verbose and timings:
        parts = " ".join(f"{k}={v:.2f}s" for k, v in timings.items())
        print(f"# phase timings: {parts}")
    results["algo"] = algo
    return results
