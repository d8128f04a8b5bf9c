"""Starts the ranks of a group on this host: one process a rank, spawned
with ``torch.multiprocessing``, each joining the group through a
``file://`` rendezvous in a fresh temporary directory (so that concurrent
launches never race for a TCP port).

``run_ranks(target, n, args)`` runs ``target(group, *args)`` in every rank
and returns the ranks' results in rank order.  ``target`` must be a
module-level function (it is pickled by name).  Each rank writes its result,
or the traceback of what it raised, to a file in that directory, so nothing
passes through a pipe that could fill.  The launcher waits until every rank
has exited: when a rank fails, the others are stopped (they would wait in
their next collective until its timeout) and the launch raises with the
failed ranks' tracebacks, the first written first.  With a ``deadline``
(seconds; tests give one) every rank is stopped when it passes and the
launch raises ``TimeoutError``.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence


def _rank_main(rank: int, world_size: int, init_method: str, device: str,
               backend: Optional[str], target: Callable, args: Sequence,
               out_dir: str) -> None:
    import torch

    from quickrank_tpu_torch.parallel.mesh import leave, make_mesh

    if torch.device(device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(1)
    group = None
    try:
        group = make_mesh(world_size, rank, init_method, device=device, backend=backend)
        result = target(group, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(result, f)
        os.replace(os.path.join(out_dir, f"rank{rank}.pkl.tmp"),
                   os.path.join(out_dir, f"rank{rank}.pkl"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        leave(group)


def run_ranks(target: Callable, world_size: int, args: Sequence = (),
              device: str = "cuda", backend: Optional[str] = None,
              deadline: Optional[float] = None) -> list:
    """Run ``target(group, *args)`` in ``world_size`` spawned ranks (see the
    module docstring) and return their results in rank order."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="qr_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, init_method, device, backend, target,
                                   tuple(args), tmp),
                             name=f"rank{r}", daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        stop_at = time.monotonic() + deadline if deadline is not None else float("inf")
        failed = None
        try:
            while True:
                codes = [p.exitcode for p in procs]
                failed = next((r for r, c in enumerate(codes) if c not in (None, 0)), None)
                if failed is not None or all(c == 0 for c in codes):
                    break
                if time.monotonic() > stop_at:
                    raise TimeoutError(
                        f"{world_size} ranks of {getattr(target, '__name__', target)} "
                        f"did not finish within {deadline:.0f} s (exit codes {codes})")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        if failed is not None:
            # a rank whose peer died fails too: the tracebacks in the order
            # they were written put the first failure first
            errs = sorted((os.path.getmtime(path), path) for path in
                          (os.path.join(tmp, f"rank{r}.err") for r in range(world_size))
                          if os.path.exists(path))
            why = "\n".join(f"--- {os.path.basename(path)[:-4]}:\n{open(path).read()}"
                            for _, path in errs) or "(no traceback written)"
            raise RuntimeError(
                f"rank {failed} of {world_size} exited with code {procs[failed].exitcode}:\n"
                f"{why}")
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
