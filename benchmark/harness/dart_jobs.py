"""The ``dart_jobs`` loop: whole DART training jobs back to back on one
``TrainData``, as ``train_jobs`` runs LambdaMART's.

Set-up, the window and the traced stretch are ``train_jobs``'s.  Each job's
history gives what the program keeps no counter of here: the trees it
dropped an iteration (``dropped_per_iter``), summed over the window for
``drops_per_tree.dart`` and counted by size for ``mfu.dart``, and, of the
traced job, the drop counts and the iterations that rescored the folds
(``rescored``), for ``k1_delta_roofline``.

The check follows the first ``check_trees`` iterations of the window's last
job with the plain DART reference (``benchmark/reference/dart.py``), which
draws the dropped sets from the configuration's seed, bins the drawn
features and grows each tree from the lambdas of its own dropped-out
scores, in float64.  The numbers compared:

* ``ndcg_gap``: the largest gap, over the iterations before the first drop,
  between the train NDCG the job reported after each and the reference's;
* ``grad_gap``: the first tree's output over the train docs, as the gap of
  the two vectors' norms over the reference's norm;
* ``change_gap``: the same for the weighted outputs of the trees fitted
  before the first drop, as many as the job's model keeps, each at its final
  weight (the weight after the job's best iteration; the reference's from
  its own draws), so every dropout and restore of the job is in it;
* ``delta_gap``: the tree of the first iteration that drops, on its own
  leaves: the norm of its output less the Newton steps that the reference's
  lambdas of that iteration, the dropped-out scores', give those leaves,
  over the norm of those steps;
* ``drop_gap``: the number of the job's iterations whose dropped set is not
  the reference's.

Why ``delta_gap`` takes the program's leaves, and the NDCG stops at the
first drop: once a dropped tree leaves the scores, docs that share every
kept tree's leaf but not the dropped tree's tie in exact arithmetic and a
last bit apart in any rounding, so their rank order, the NDCG and the
lambdas follow those bits, and near-equal splits follow the lambdas.  The
gap of norms of the eight trees' weighted sum read 3.1e-3 on a sound run and
8.5e-3 with the delta left out, and the NDCG after iteration 8 1.1e-3 on a
sound run and 3.4e-4 with the delta left out.  Valued on the program's own
leaves, the tree keeps only the lambdas' sums over them.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from benchmark.harness import train_jobs
from benchmark.reference import dart as ref_dart, letor, trees as ref_trees


class Loop(train_jobs.Loop):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.histories: list = []  # the history of each job since the last reset

    def setup(self):
        super().setup()
        self.valid_docs = int(self.valid_ds.num_docs)

    def _job(self, ntrees: int):
        model, grown = super()._job(ntrees)
        self.histories.append(model.history)
        return model, grown

    def window(self, seconds: float) -> dict:
        self.histories = []
        win = super().window(seconds)
        counts = [k for h in self.histories for k in h["dropped_per_iter"]]
        win["dropped"] = sum(counts)
        win["drop_counts"] = dict(sorted(Counter(counts).items()))
        return win

    def traced(self) -> dict:
        self.histories = []
        out = super().traced()
        h = self.histories[-1]
        out.update(drop_counts=list(h["dropped_per_iter"]), rescored=list(h["rescored"]))
        return out

    def release(self):
        h = self.judged.history
        self.program_dropped = [list(s) for s in h["dropped"]]
        self.program_best = int(h["best_iteration"])
        super().release()

    # -- the check ------------------------------------------------------------

    def _schedule(self, iterations: int):
        p = self.cfg["params"]
        return ref_dart.schedule(iterations, p["rate_drop"], p["skip_drop"], p["seed"],
                                 p["shrinkage"])

    def reference(self, dtype=torch.float64, fault: str = "") -> dict:
        """The reference's first ``check_trees`` iterations at ``dtype`` (and
        ``fault``, ``reference/dart.py::run``'s)."""
        p = self.cfg["params"]
        lay = letor.Layout(self.counts, self.x.device)
        table = letor.thresholds(self.x, p["num_thresholds"])
        return ref_dart.run(
            letor.bins(self.x, table), table, self.labels, lay, self.traffic["check_trees"],
            nleaves=p["num_leaves"], min_leaf_support=p["min_leaf_support"],
            shrinkage=p["shrinkage"], rate_drop=p["rate_drop"], skip_drop=p["skip_drop"],
            seed=p["seed"], sample_type=p["sample_type"],
            cutoff=int(self.cfg["metric"].partition("@")[2]), dtype=dtype, fault=fault)

    def dart_numbers(self, out, node, ndcg, weights, dropped, best: int, ref: dict) -> dict:
        """The five numbers of the outputs ``out`` of the kept trees, at
        ``weights``, their leaf of each doc ``node`` (a function of the tree
        index), the NDCG after each iteration and the dropped sets of a run
        whose best iteration was ``best``."""
        first = next((i for i, d in enumerate(dropped) if d), len(dropped))
        k = min(len(out), len(ref["out"]), first)
        _, ref_weights = self._schedule(best)
        sets, _ = self._schedule(len(dropped))
        delta_gap = 0.0
        if first < len(ref["fit"]):
            if first >= len(out):
                raise train_jobs.CheckError(f"the job kept {len(out)} trees; the check "
                                            f"follows the tree of iteration {first + 1}")
            leaf = node(first)
            lam, w = ref["fit"][first]
            steps = ref_trees.newton_leaves(leaf, lam, w, int(leaf.max()) + 1)[leaf]
            delta_gap = float(torch.linalg.vector_norm(out[first] - steps)
                              / torch.linalg.vector_norm(steps))
        return dict(
            ndcg_gap=max(abs(a - b) for a, b in zip(ndcg[:first], ref["ndcg"][:first])),
            grad_gap=train_jobs._norm_gap(out[0], ref["out"][0]),
            change_gap=train_jobs._norm_gap(sum(w * o for w, o in zip(weights[:k], out[:k])),
                                            sum(w * o for w, o in zip(ref_weights[:k],
                                                                      ref["out"][:k]))),
            delta_gap=delta_gap,
            drop_gap=float(sum(a != b for a, b in zip(dropped, sets))))

    def check(self) -> dict:
        ref = self.reference()
        out, ndcg = self.program_outputs()
        trees = self.program_trees[:len(out)]
        weights = [t["weight"] for t in trees]

        def node(i):
            ids = dict(trees[i], leaf_value=np.arange(len(trees[i]["leaf_value"])))
            return ref_trees.tree_output(self.x, ids).long()

        return self.dart_numbers(out, node, ndcg, weights, self.program_dropped,
                                 self.program_best, ref)

    def control(self, dtype, fault: str = "") -> dict:
        """The check with the reference at ``dtype`` (and ``fault``) in the
        program's place, its run of ``check_trees`` iterations taken whole."""
        ref = self.reference()
        ctl = self.reference(dtype, fault)
        return self.dart_numbers(ctl["out"], ctl["node"].__getitem__, ctl["ndcg"],
                                 ctl["weights"], ctl["dropped"], len(ctl["out"]), ref)

    # -- what the per-layer readers and the roofline need ---------------------

    def work(self) -> dict:
        return dict(super().work(), valid_docs=self.valid_docs)
