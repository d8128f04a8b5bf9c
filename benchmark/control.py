"""The checks' controls: the numbers a cell compares when the plain reference,
computed in a lower precision or with a planted fault, stands in the
program's place.  Not run by the benchmark's runs; it sets the upper
readings of the limits in ``benchmark/cells/<cell>.json``.

    python benchmark/control.py --workload <name> --seeds 1,2,3 --variant bf16

Variants: ``bf16`` (the reference in bfloat16, the precision below the
configuration's float32), and for training cells ``half`` (every other
query's lambdas left out), ``altered`` (the first tree's outputs scaled by
1.01) and ``unchanged`` (no tree adds anything), each in float32.  One JSON
line a seed, then one with the smallest reading of each number.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import cell as cells  # noqa: E402

VARIANTS = {"bf16": (torch.bfloat16, ""), "half": (torch.float32, "half"),
            "altered": (torch.float32, "altered"), "unchanged": (torch.float32, "unchanged")}


def readings(cell: cells.Cell, seed: int, variant: str, device) -> dict:
    dtype, fault = VARIANTS[variant]
    loop = cell.loop(seed, device)
    loop.draw()
    return loop.control(dtype, fault)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default="bf16", choices=sorted(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = cells.Cell(args.workload, ROOT)
    low: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        got = readings(cell, seed, args.variant, args.device)
        for k, v in got.items():
            low[k] = min(low.get(k, float("inf")), v)
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "numbers": got, "seconds": time.perf_counter() - t}), flush=True)
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "variant": args.variant, "smallest": low,
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
