"""The ``score_batches`` loop: a closed loop of batch scoring, as a ranking
service that scores every candidate of a batch of queries with one model.

Set-up draws the configuration's serving model and a pool of feature batches
on the device from the seed, and builds the program's scorer with
``device_scorer`` (the table build and upload: ``tables_s.score``).  The
window keeps ``ahead`` batches in flight: each batch is dispatched to the
scorer, its scores are copied to pinned host memory, and the oldest batch in
flight is waited for once more than ``ahead`` are.  A batch's time runs from
its dispatch (an event on an idle side stream, so it fires when the host
dispatches) to the end of its copy (an event after the copy), both on the
device's clock.  A sample of ``sample_batches`` batches, drawn from the seed
over the whole window (reservoir sampling), keeps its scores for the check.

The check scores each pool batch the sample holds with the plain reference
(``benchmark/reference/scorers.py``) in float64, and compares every score of
every sampled batch: ``score_gap`` is the largest gap over ``max(1, largest
|reference score|)``.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import draws
from benchmark.reference import scorers


class Loop:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, chips: int = 1):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.chips = chips
        self.setup_info: dict = {}

    def draw(self):
        """The serving model and the feature pool (all the check needs)."""
        m, tr = self.cfg["serving"], self.traffic
        F = self.cfg["data"]["features"]
        if m["model"] == "oblivious":
            self.levels = draws.oblivious_model(m["trees"], m["depth"], F, self.seed)
            self.nodes = draws.oblivious_as_nodes(self.levels)
        else:
            self.levels = None
            self.nodes = draws.bestfirst_model(m["trees"], m["leaves"], F, self.seed)
        self.pool = draws.feature_pool(tr["pool_batches"], tr["batch_docs"], F, self.seed,
                                       self.device)

    def setup(self):
        from benchmark.harness import program

        tr = self.traffic
        F = self.cfg["data"]["features"]
        t = time.perf_counter()
        self.draw()
        self.setup_info["draw_s"] = time.perf_counter() - t
        m = self.cfg["serving"]
        model = program.serving_model(self.cfg, self.nodes)
        t = time.perf_counter()
        fn, _ = model.device_scorer(program.empty_dataset(F), device=self.device)
        self._sync()
        self.setup_info["tables_s"] = time.perf_counter() - t
        path = model.scorer_path()
        if path != m["path"]:
            raise RuntimeError(f"the program serves this model on its {path!r} path, "
                               f"the configuration asks for {m['path']!r}")
        self.setup_info["path"] = path
        self.fn = fn
        cuda = torch.device(self.device).type == "cuda"
        ring = tr["ahead"] + 1
        self.host = [torch.empty(tr["batch_docs"], dtype=torch.float32, pin_memory=cuda)
                     for _ in range(ring)]
        if cuda:
            self.side = torch.cuda.Stream()
            self.events = [(torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True)) for _ in range(ring)]
        t = time.perf_counter()
        self._loop(batches=tr["warmup_batches"], sample=0)
        self.setup_info["warmup_s"] = time.perf_counter() - t

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def _loop(self, seconds: float = 0.0, batches: int = 0, sample: int = 0):
        """Run batches until ``seconds`` have passed (or ``batches`` are
        done); returns (batches, wall seconds, per-batch ms, sample)."""
        tr = self.traffic
        P, ahead = tr["pool_batches"], tr["ahead"]
        cuda = torch.device(self.device).type == "cuda"
        rng = np.random.default_rng(draws.substream(self.seed, 11))
        kept: list = []
        ms: list = []
        flight: collections.deque = collections.deque()

        def finish():
            i, buf, ev = flight.popleft()
            if cuda:
                ev[1].synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
            if sample:
                j = i if i < sample else int(rng.integers(0, i + 1))
                if j < sample:
                    row = (i, buf.numpy().copy())
                    if len(kept) < sample:
                        kept.append(row)
                    else:
                        kept[j] = row

        i = 0
        t0 = time.perf_counter()
        while (batches and i < batches) or (not batches and time.perf_counter() - t0 < seconds):
            slot = i % len(self.host)
            buf = self.host[slot]
            ev = self.events[slot] if cuda else None
            with record_function("bench.batch"):
                if cuda:
                    ev[0].record(self.side)
                out = self.fn(self.pool[i % P])
                buf.copy_(out, non_blocking=cuda)
                if cuda:
                    ev[1].record()
            flight.append((i, buf, ev))
            i += 1
            if len(flight) > ahead:
                finish()
        while flight:
            finish()
        return i, time.perf_counter() - t0, ms, kept

    def window(self, seconds: float) -> dict:
        n, wall, ms, kept = self._loop(seconds=seconds, sample=self.traffic["sample_batches"])
        self.sample = kept
        return dict(wall_s=wall, batches=n, docs=n * self.traffic["batch_docs"],
                    batch_ms=ms, attempted=n, failed=0)

    def traced(self) -> dict:
        n, _, _, _ = self._loop(batches=self.traffic["trace_batches"])
        return dict(batches=n)

    def release(self):
        self.fn = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------

    def _reference(self, b: int, dtype) -> torch.Tensor:
        x = self.pool[b]
        if self.levels is not None:
            lv = {k: torch.as_tensor(v) for k, v in self.levels.items()}
            return scorers.score_oblivious(x, lv["fid"], lv["thr"], lv["leaf"], lv["weight"],
                                           dtype)
        n = {k: torch.as_tensor(np.asarray(self.nodes[k])) for k in
             ("feature", "threshold", "left", "right", "is_leaf", "leaf_value", "weight")}
        return scorers.score_trees(x, n["feature"], n["threshold"], n["left"], n["right"],
                                   n["is_leaf"], n["leaf_value"], n["weight"], dtype)

    def _gap(self, sample, ref: dict) -> float:
        gap = 0.0
        P = self.traffic["pool_batches"]
        for i, scores in sample:
            r = ref[i % P]
            got = torch.as_tensor(scores, dtype=torch.float64)
            scale = max(1.0, float(r.abs().max()))
            gap = max(gap, float((got - r).abs().max()) / scale)
        return gap

    def check(self) -> dict:
        if not self.sample:
            return dict(score_gap=float("inf"))
        P = self.traffic["pool_batches"]
        ref = {b: self._reference(b, torch.float64).cpu()
               for b in sorted({i % P for i, _ in self.sample})}
        return dict(score_gap=self._gap(self.sample, ref))

    def control(self, dtype, fault: str = "") -> dict:
        """The check with the reference at ``dtype`` in the program's place,
        over every pool batch."""
        P = self.traffic["pool_batches"]
        ref = {b: self._reference(b, torch.float64).cpu() for b in range(P)}
        ctl = [(b, self._reference(b, dtype).double().cpu().numpy()) for b in range(P)]
        return dict(score_gap=self._gap(ctl, ref))

    def work(self) -> dict:
        m = self.cfg["serving"]
        w = dict(rows=self.traffic["batch_docs"], features=self.cfg["data"]["features"],
                 trees=m["trees"])
        if self.levels is not None:
            w["depth"] = m["depth"]
        else:
            w["leaves"] = m["leaves"]
            w["mean_leaf_depth"] = draws.leaf_depths(self.nodes)
        return w
