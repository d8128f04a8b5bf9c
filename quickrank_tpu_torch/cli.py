"""quicklearn: the training command line (counterpart of quickrank_tpu/cli.py).

The flag surface of the reference binary (src/quicklearn.cc:142-504, defaults
:97-140) with the JAX package's names and defaults, across its option groups:
training general, tree-based, meta-LtR, DART, selective sampling, CA/LS,
optimization, testing and code generation.  Every flag is parsed; ``--generator
pt2`` writes a ``torch.export`` archive of the scorer, and ``--generator
stablehlo`` (JAX's ``jax.export`` artifact) is refused in ``driver.run``.
``--device`` (cuda or cpu, default cuda) takes the place of ``--platform``:
without a CUDA device ``--device cuda`` is an error, never a CPU run.
``--num-shards N`` trains in N ranks (``driver.run``), ``--num-feat-shards K``
in N x K ranks of a 2-D data x feature mesh.

Run as ``python -m quickrank_tpu_torch.cli --help``.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="quicklearn-torch",
        description="learning-to-rank on one CUDA device (QuickRank-compatible CLI)",
    )
    g = p.add_argument_group("training options")
    g.add_argument("--algo", default="LAMBDAMART",
                   help="LtR algorithm [MART|LAMBDAMART|OBVMART|OBVLAMBDAMART|"
                        "DART|RANKBOOST|RANDOMFOREST|LAMBDAMART-SELECTIVE|"
                        "STOCHASTIC-NEGATIVE|COORDASC|LINESEARCH|CUSTOM]")
    g.add_argument("--train-metric", default="NDCG")
    g.add_argument("--train-cutoff", type=int, default=10)
    g.add_argument("--partial", type=int, default=100,
                   help="save partial model every this many iterations")
    g.add_argument("--train", help="training file (SVML/LETOR)")
    g.add_argument("--valid", help="validation file")
    g.add_argument("--features",
                   help="feature-subset file: one 1-based feature id per "
                        "line; datasets are restricted to these columns")
    g.add_argument("--model-in", help="input model file")
    g.add_argument("--model-out", help="output model file")
    g.add_argument("--skip-train", action="store_true")
    g.add_argument("--restart-train", action="store_true",
                   help="restart training from a previous partial model")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--num-shards", type=int, default=0,
                   help="train query-sharded in this many ranks, one a "
                        "device (NCCL, a card a rank; gloo ranks on the CPU "
                        "with --device cpu); rank 0 writes the model "
                        "(0 = one process)")
    g.add_argument("--num-feat-shards", type=int, default=0,
                   help="also shard the histogram/split-scan feature axis "
                        "over this many ranks: --num-shards x this many "
                        "ranks of a 2-D data x feature mesh (not with "
                        "RANKBOOST, COORDASC, LINESEARCH, --restart-train or "
                        "--collapse-leaves-factor; 0 or 1 = no feature axis)")
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="training and scoring device; cuda without a CUDA "
                        "device is an error")
    g.add_argument("--quiet", action="store_true",
                   help="suppress per-iteration progress output")
    g.add_argument("--trace", metavar="DIR",
                   help="capture a device trace of the training phase "
                        "into DIR")

    t = p.add_argument_group("tree-based options")
    t.add_argument("--num-trees", type=int, default=1000)
    t.add_argument("--shrinkage", type=float, default=0.10)
    t.add_argument("--num-thresholds", type=int, default=255,
                   help="feature quantization bins (reference default 255)")
    t.add_argument("--min-leaf-support", type=int, default=1)
    t.add_argument("--end-after-rounds", type=int, default=100)
    t.add_argument("--num-leaves", type=int, default=10)
    t.add_argument("--tree-depth", type=int, default=3)
    t.add_argument("--subsample", type=float, default=1.0)
    t.add_argument("--max-features", type=float, default=1.0)
    t.add_argument("--collapse-leaves-factor", type=float, default=0)
    t.add_argument("--max-depth", type=int, default=0,
                   help="depth cap (0 = unbounded; enables fast scorer)")
    t.add_argument("--growth", default="best",
                   help="[best|level|bestk] tree growth mode (level = one "
                        "histogram pass per level; bestk = best-first priority "
                        "with --split-pack leaves split per histogram pass)")
    t.add_argument("--split-pack", type=int, default=4,
                   help="max heap leaves split per histogram pass under "
                        "--growth bestk (1 = exact best-first)")

    s = p.add_argument_group("selective sampling options")
    s.add_argument("--sampling-iterations", type=int, default=0)
    s.add_argument("--rank-sampling-factor", type=float, default=1.0)
    s.add_argument("--random-sampling-factor", type=float, default=0.0)
    s.add_argument("--normalization-factor", type=float, default=100)
    s.add_argument("--adaptive-strategy", default="NO")
    s.add_argument("--negative-strategy", default="RATIO")

    m = p.add_argument_group("meta-LtR options")
    m.add_argument("--meta-algo", help="[METACLEAVER]")
    m.add_argument("--final-num-trees", type=int, default=1000)
    m.add_argument("--opt-last-only", action="store_true")
    m.add_argument("--meta-end-after-rounds", type=int, default=3)
    m.add_argument("--meta-verbose", action="store_true")

    d = p.add_argument_group("DART options")
    d.add_argument("--sample-type", default="UNIFORM")
    d.add_argument("--normalize-type", default="TREE")
    d.add_argument("--adaptive-type", default="FIXED")
    d.add_argument("--rate-drop", type=float, default=0.1)
    d.add_argument("--skip-drop", type=float, default=0.0)
    d.add_argument("--keep-drop", action="store_true")
    d.add_argument("--best-on-train", action="store_true")
    d.add_argument("--random-keep", type=float, default=0.0)
    d.add_argument("--drop-on-best", action="store_true")

    c = p.add_argument_group("coordinate ascent / line search options")
    c.add_argument("--num-samples", type=int, default=21)
    c.add_argument("--window-size", type=float, default=10.0)
    c.add_argument("--reduction-factor", type=float, default=0.95)
    c.add_argument("--max-iterations", type=int, default=100)
    c.add_argument("--max-failed-valid", type=int, default=20)
    c.add_argument("--adaptive", action="store_true")

    o = p.add_argument_group("optimization options")
    o.add_argument("--opt-algo", help="[EPRUNING]")
    o.add_argument("--opt-method",
                   help="[RANDOM|RANDOM_ADV|LOW_WEIGHTS|SKIP|LAST|"
                        "QUALITY_LOSS|QUALITY_LOSS_ADV|SCORE_LOSS]")
    o.add_argument("--pruning-rate", type=float, default=0.5)
    o.add_argument("--with-line-search", action="store_true")
    o.add_argument("--line-search-model")
    o.add_argument("--opt-model",
                   help="optimizer model file (output when optimizing, "
                        "input when no --opt-algo is given)")
    o.add_argument("--opt-algo-model",
                   help="output file for the optimized LTR model")
    o.add_argument("--opt-model-out",
                   help="deprecated alias for --opt-algo-model")
    o.add_argument("--train-partial",
                   help="partial-scores SVML file (loaded if present, "
                        "else extracted and saved)")
    o.add_argument("--valid-partial",
                   help="partial-scores SVML file for the validation split")

    te = p.add_argument_group("testing options")
    te.add_argument("--test-metric", default="NDCG")
    te.add_argument("--test-cutoff", type=int, default=10)
    te.add_argument("--test", help="test file")
    te.add_argument("--scores", help="output per-doc scores file")
    te.add_argument("--detailed", help="output per-tree SVML scores file")

    cg = p.add_argument_group("code generation options")
    cg.add_argument("--model-file", help="XML model to translate")
    cg.add_argument("--code-file", help="output source file")
    cg.add_argument("--generator", default="condop",
                    help="[condop|oblivious|vpred|pt2]")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    params = {k: v for k, v in vars(args).items() if v is not None}
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")
    from quickrank_tpu_torch import driver

    banner = (
        "#      _____  _____          _\n"
        "#     /    / /____/          quickrank_tpu_torch: LtR on PyTorch + CUDA\n"
        "#    /____\\ /    \\           (QuickRank-compatible)\n"
    )
    print(banner)
    driver.run(params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
