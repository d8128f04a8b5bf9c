"""Tracing and profiling helpers (counterpart of
quickrank_tpu/utils/profiling.py).

The reference's observability is std::chrono phase prints (mart.cc:216-258,
svml.cc:190-196).  Here: wall-clock phase timers for the host's
orchestration, ``torch.profiler`` traces of a code block (host operators,
and the card's kernels when CUDA runs) written as Chrome trace JSON, which
chrome://tracing and Perfetto open, and the program's named spans
(:func:`span`), which such a trace holds beside the kernels.

Spans are named ``qr.<layer>[.<section>]`` and nest: ``qr.learn.init`` and
one ``qr.boost.iter`` an iteration (``learning/mart.py``), inside it
``qr.boost.lambdas``, ``qr.grow`` (the growers of ``trees/``, with their
``qr.grow.split``, ``.readback``, ``.route``, ``.hist`` and ``.level``
sections) and ``qr.boost.metrics``; ``qr.data.build`` around the layout,
binning and upload, with ``qr.data.bin`` inside it around the binning (on
the card the rows' upload and the binning kernel's launches);
``qr.score.dispatch`` around a scorer call.  Every
blocking read of the card by the boosting loop sits in a ``*.readback``
span, so a tree's host time splits into work and waiting.
"""

from __future__ import annotations

import contextlib
import os
import time

from torch.autograd import profiler as _profiler

#: what :func:`span` returns while no profiler records: one shared context
#: that does nothing
_OFF = contextlib.nullcontext()


def span(name: str):
    """A named range of the program: ``record_function(name)`` while a
    ``torch.profiler`` profile records, so that the range lands in its
    trace on the clock of the card's kernels; otherwise the one shared
    no-op context (:data:`_OFF`), which creates no profiler record and
    allocates nothing.  The profiler being on is the only switch."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def phase_timer(name: str, sink: dict | None = None, verbose: bool = True):
    """Wall-clock a phase; optionally add its seconds into ``sink[name]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + dt
        if verbose:
            print(f"# [{name}] {dt:.3f} s")


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool | None = None):
    """Capture a ``torch.profiler`` trace around a code block into
    ``log_dir/quickrank_torch.<pid>.trace.json`` (the directory is made if
    needed).  ``cuda`` records the card's activity too; None means whenever
    a CUDA device is available.  Yields the path the trace is written to."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"quickrank_torch.{os.getpid()}.trace.json")
    with profile(activities=activities) as prof:
        yield path
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
