"""Runs one cell of the benchmark once and prints its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up draws the inputs and the model from ``--seed`` and warms up; the
window measures for ``--seconds``; ``--trace 1`` adds a traced stretch after
the window and reports the per-layer metrics in place of the end-to-end
ones.  The check against the plain reference runs last.  The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every kernel cache at a fixed place inside the checkout; the program's
# nvcc library builds into quickrank_tpu_torch/build/ itself
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "benchmark", ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "benchmark", ".cache", "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402


def _nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell as cells, guard, runner

    cell = cells.Cell(args.workload, ROOT)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    lib = os.path.join(ROOT, "quickrank_tpu_torch", "build", "libqrkernels.so")
    runner.log("card", _nvidia_smi())
    runner.log("kernel library", "found" if os.path.exists(lib) else "built in this run")
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = guard.forbidden_loaded()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
