"""The ``train_jobs`` loop: whole training jobs back to back on one
``TrainData``, as a user who trains model after model on one prepared fold.

Set-up draws the train and valid folds from the seed, builds the
``TrainData`` once (host binning and upload: ``init_s.train``) and runs a
short warm-up job.  The window runs ``learn`` jobs of the configuration's
``ntrees`` trees, each with the valid fold, until ``--seconds`` have passed;
it closes when the job running then ends, and ``s_per_tree`` is the window's
wall time over the trees its jobs grew.  The traced stretch runs one more job.

The check follows the first ``check_trees`` trees of the window's last job
with the plain reference (``benchmark/reference``), which bins the drawn
features, computes the lambdas and grows each tree itself from its own
scores, in float64.  The numbers compared:

* ``ndcg_gap``: the largest gap, over those trees, between the train NDCG
  the job reported after each tree and the reference's;
* ``grad_gap``: the first tree's output over the train docs (its Newton step
  from the first lambdas), as the gap of the two vectors' norms over the
  reference's norm;
* ``change_gap``: the same for the scores the first ``check_trees`` trees
  add up to (as many of them as the job's model keeps: ``learn`` rolls the
  model back to its best iteration on the valid fold).

The program's trees are evaluated on the raw feature values, so its binning
is judged with its splits.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import draws
from benchmark.reference import letor, trees as ref_trees


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Loop:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, chips: int = 1):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.chips = chips
        self.setup_info: dict = {}

    # -- set-up ---------------------------------------------------------------

    def _fold(self, fold: int, queries: int):
        d = self.cfg["data"]
        return draws.letor_fold(queries, d["avg_docs_per_query"], d["features"],
                                d["sizes_seed"] + fold, self.seed, fold, self.device,
                                d["noise"], d["grades"])

    def draw(self):
        """The train fold, drawn on the device (all the check needs)."""
        self.x, self.labels, self.counts = self._fold(0, self.cfg["data"]["train_queries"])

    def setup(self):
        from benchmark.harness import program

        self.program = program
        t = time.perf_counter()
        self.draw()
        vx, vlabels, vcounts = self._fold(1, self.cfg["data"]["valid_queries"])
        self.train_ds = program.dataset(self.x, self.labels, self.counts, "train")
        self.valid_ds = program.dataset(vx, vlabels, vcounts, "valid")
        del vx, vlabels
        self.setup_info["draw_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.td = program.train_data(self.train_ds, self.cfg, self.device)
        _sync(self.device)
        self.setup_info["init_s"] = time.perf_counter() - t
        self.metric = program.metric(self.cfg)
        t = time.perf_counter()
        self._job(self.traffic["warmup_trees"])
        _sync(self.device)
        self.setup_info["warmup_s"] = time.perf_counter() - t
        self.setup_info["docs"] = int(self.counts.sum())

    def _job(self, ntrees: int):
        model = self.program.learner(self.cfg, ntrees)
        with record_function("bench.learn"):
            hist = model.learn(self.td, self.valid_ds, self.metric, verbose=False,
                               device=self.device)
        return model, len(hist["train"])

    # -- the window -----------------------------------------------------------

    def window(self, seconds: float) -> dict:
        syncs0 = self.program.host_syncs()
        trees = jobs = 0
        job_s = []
        t0 = time.perf_counter()
        while True:
            model, grown = self._job(self.cfg["ntrees"])
            trees += grown
            jobs += 1
            job_s.append(time.perf_counter() - t0 - sum(job_s))
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.judged = model
        return dict(wall_s=wall, trees=trees, jobs=jobs, attempted=jobs, failed=0,
                    host_syncs=self.program.host_syncs() - syncs0, job_s=job_s,
                    splits_per_tree=_splits(model))

    def traced(self) -> dict:
        _, grown = self._job(self.cfg["ntrees"])
        return dict(trees=grown)

    def release(self):
        """Free the program's state before the reference runs."""
        self.td = self.train_ds = self.valid_ds = None
        self.program_trees = self.program.trees_of(self.judged)
        self.program_ndcg = list(self.judged.history["train"])
        self.judged = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------

    def reference(self, dtype=torch.float64, fault: str = ""):
        """The reference's first ``check_trees`` trees (dicts with ``out``, the
        per-doc output) and its train NDCG after each, at ``dtype``.  A
        ``fault`` plants one of the check's faults in it: ``half`` leaves
        out every other query's lambdas, ``altered`` scales the first tree's
        outputs by 1.01, ``unchanged`` adds nothing to the scores."""
        cfg, p = self.cfg, self.cfg["params"]
        cutoff = int(cfg["metric"].partition("@")[2])
        lay = letor.Layout(self.counts, self.x.device)
        table = letor.thresholds(self.x, p["num_thresholds"])
        bin_ids = letor.bins(self.x, table)
        scores = torch.zeros(lay.n, dtype=dtype, device=self.x.device)
        qmask = None
        if fault == "half":
            qmask = torch.arange(lay.Q, device=self.x.device) % 2 == 0
        out, ndcg = [], []
        for t in range(self.traffic["check_trees"]):
            lam, w = letor.lambdas(scores, self.labels, lay, cutoff, dtype, query_mask=qmask)
            if "tree_depth" in p:
                tree = ref_trees.grow_oblivious(bin_ids, table, lam, w, p["tree_depth"],
                                                p["min_leaf_support"])
                step = tree["leaf"][tree["node"]]
            else:
                tree = ref_trees.grow_best_first(bin_ids, table, lam, w, p["num_leaves"],
                                                 p["min_leaf_support"])
                step = tree["leaf_value"][tree["node"]]
            if fault == "altered" and t == 0:
                step = step * 1.01
            if fault == "unchanged":
                step = torch.zeros_like(step)
            scores = scores + (p["shrinkage"] * step).to(dtype)
            out.append(step.double())
            ndcg.append(letor.ndcg(scores, self.labels, lay, cutoff, dtype))
        return out, ndcg

    def numbers(self, program_out, program_ndcg, ref_out, ref_ndcg) -> dict:
        """The three numbers; trees are compared as far as the program's
        model keeps them (``learn`` rolls back to the best iteration on the
        valid fold), the NDCG after every one of the first trees."""
        k = min(len(program_out), len(ref_out))
        w = self.cfg["params"]["shrinkage"]
        ndcg_gap = max(abs(a - b) for a, b in zip(program_ndcg, ref_ndcg))
        grad_gap = _norm_gap(program_out[0], ref_out[0])
        change_gap = _norm_gap(w * sum(program_out[:k]), w * sum(ref_out[:k]))
        return dict(ndcg_gap=ndcg_gap, grad_gap=grad_gap, change_gap=change_gap)

    def program_outputs(self):
        k = self.traffic["check_trees"]
        if not self.program_trees or len(self.program_ndcg) < k:
            raise CheckError(f"the job kept {len(self.program_trees)} trees and reported "
                             f"{len(self.program_ndcg)} iterations; the check follows {k}")
        outs = [ref_trees.tree_output(self.x, t) for t in self.program_trees[:k]]
        return outs, self.program_ndcg[:k]

    def check(self) -> dict:
        ref_out, ref_ndcg = self.reference()
        prog_out, prog_ndcg = self.program_outputs()
        return self.numbers(prog_out, prog_ndcg, ref_out, ref_ndcg)

    def control(self, dtype, fault: str = "") -> dict:
        """The check with the reference at ``dtype`` (and ``fault``) in the
        program's place."""
        ref_out, ref_ndcg = self.reference()
        ctl_out, ctl_ndcg = self.reference(dtype, fault)
        return self.numbers(ctl_out, ctl_ndcg, ref_out, ref_ndcg)

    # -- what the per-layer readers and the roofline need ---------------------

    def work(self) -> dict:
        counts = np.asarray(self.counts, np.int64)
        p = self.cfg["params"]
        depth = p.get("tree_depth")
        return dict(docs=int(counts.sum()), features=self.cfg["data"]["features"],
                    pairs=int((counts.astype(np.float64) ** 2).sum()),
                    leaves=2 ** depth if depth else p["num_leaves"], depth=depth,
                    bins=p["num_thresholds"] + 1)


class CheckError(RuntimeError):
    """The run's outputs cannot be compared (the check fails)."""


def _norm_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    na, nb = float(torch.linalg.vector_norm(a.double())), float(torch.linalg.vector_norm(b.double()))
    return abs(na - nb) / max(nb, 1e-300)


def _splits(model) -> float:
    h = model.ensemble.numpy()
    T = h["num_trees"]
    return float((h["feature"][:T] >= 0).sum() / max(T, 1))
