"""``--num-shards`` in the port's two CLIs, on the CPU: quicklearn trains in
two spawned gloo ranks (rank 0 writes the model and the test scores), and
quickscore fans the doc rows out over several blocks in one process."""

import numpy as np
import pytest
import torch

from quickrank_tpu_torch import driver
from quickrank_tpu_torch.cli import build_parser
from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.parallel.mesh import RowShards, score_rows_sharded
from quickrank_tpu_torch.quickscore import main as quickscore_main
from torch_cli_common import _flags, _ndcg10, port_main, read_svml, svml_dir  # noqa: F401

#: seconds the two ranks' launch may take (it takes ~5 s)
DEADLINE = 120.0


def test_quicklearn_trains_query_sharded_on_cpu(svml_dir, tmp_path):
    """``--num-shards 2 --device cpu``: two ranks train LambdaMART; rank 0
    alone writes the model and the test scores, which equal quickscore's on
    that model, and the test NDCG@10 is within tests/test_sharding.py's 1e-2
    of the unsharded run's."""
    runs = {}
    for shards in (0, 2):
        out, scores = tmp_path / f"m{shards}.xml", tmp_path / f"s{shards}.txt"
        extra = ["--algo", "LAMBDAMART", "--device", "cpu", "--scores", str(scores),
                 "--partial", "0"] + (["--num-shards", str(shards)] if shards else [])
        # quicklearn's own parse and pipeline (cli.main), with a deadline on
        # the ranks' launch
        args = vars(build_parser().parse_args(_flags(svml_dir, out, extra)))
        driver.run({**{k: v for k, v in args.items() if v is not None}, "deadline": DEADLINE})
        runs[shards] = (out, scores)
    out, scores = runs[2]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m0.xml", "m2.xml", "s0.txt",
                                                          "s2.txt"]
    model = LTRAlgorithm.load(str(out))
    assert model.NAME == "LAMBDAMART" and model.ensemble.num_trees == 3
    qs = tmp_path / "qs.txt"
    assert quickscore_main(["-d", str(svml_dir / "test.svml"), "-m", str(out), "-r", "1",
                            "--device", "cpu", "-s", str(qs)]) == 0
    np.testing.assert_array_equal(np.loadtxt(qs), np.loadtxt(scores))
    test = svml_dir / "test.svml"
    assert _ndcg10(test, scores) == pytest.approx(_ndcg10(test, runs[0][1]), abs=1e-2)


def test_quickscore_num_shards_equals_one_device(svml_dir, tmp_path):
    """``quickscore --num-shards 3 --device cpu`` (three blocks, the last
    padded) writes the single-device scores bit for bit, and so does
    ``score_rows_sharded`` over five blocks."""
    model = tmp_path / "m.xml"
    assert port_main(_flags(svml_dir, model, ["--algo", "MART", "--device", "cpu",
                                              "--partial", "0"], folds=("train",))) == 0
    files = []
    for extra in ([], ["--num-shards", "3"]):
        files.append(tmp_path / f"s{len(extra)}.txt")
        assert quickscore_main(["-d", str(svml_dir / "test.svml"), "-m", str(model),
                                "-r", "2", "--device", "cpu", "-s", str(files[-1])]
                               + extra) == 0
    a, b = (np.loadtxt(f) for f in files)
    ds = read_svml(str(svml_dir / "test.svml"))
    assert a.shape == (ds.num_docs,)
    np.testing.assert_array_equal(a, b)
    loaded = LTRAlgorithm.load(str(model))
    np.testing.assert_array_equal(score_rows_sharded(loaded, ds.features, ["cpu"] * 5),
                                  loaded.score_dataset(ds, device="cpu"))


def test_num_shards_needs_a_card_a_rank(svml_dir):
    """On CUDA, quicklearn's ranks take a card each (NCCL) and the sharded
    scorer a device each: asking for more than there are raises, naming the
    count, before any rank starts."""
    count = torch.cuda.device_count()
    params = dict(algo="LAMBDAMART", train=str(svml_dir / "train.svml"),
                  num_shards=count + 1, device="cuda")
    with pytest.raises(ValueError, match=f"needs {count + 1} CUDA devices.*{count} are visible"):
        driver.run(params)
    with pytest.raises(ValueError, match=f"{count} CUDA device"):  # checked before the model
        RowShards(object(), np.zeros((4, 3), np.float32), [f"cuda:{count}"])


def test_quicklearn_dart_and_cleaver_query_sharded_on_cpu(svml_dir, tmp_path):
    """``--algo DART --num-shards 2 --device cpu`` with the optimization
    phase (``--opt-algo CLEAVER``, ``--train-partial``, ``--opt-model``):
    two ranks train DART and prune it; rank 0 alone writes the model, the
    per-tree scores of every train doc, the optimizer and the pruned model,
    whose test NDCG@10 is within tests/test_sharding.py's 1e-2 of the
    unsharded run's."""
    outs = {}
    for shards in (0, 2):
        d = tmp_path / f"s{shards}"
        d.mkdir()
        extra = ["--algo", "DART", "--rate-drop", "0.5", "--device", "cpu", "--partial", "0",
                 "--opt-algo", "CLEAVER", "--opt-method", "QUALITY_LOSS",
                 "--train-partial", str(d / "ptrain.svml"), "--opt-model", str(d / "opt.xml"),
                 "--opt-algo-model", str(d / "pruned.xml"), "--scores", str(d / "s.txt")]
        args = vars(build_parser().parse_args(_flags(svml_dir, d / "m.xml", extra, trees=4)))
        driver.run({**{k: v for k, v in args.items() if v is not None}, "deadline": DEADLINE})
        outs[shards] = d
    d = outs[2]
    assert sorted(p.name for p in d.iterdir()) == ["m.xml", "opt.xml", "pruned.xml",
                                                   "ptrain.svml", "s.txt"]
    model = LTRAlgorithm.load(str(d / "m.xml"))
    pruned = LTRAlgorithm.load(str(d / "pruned.xml"))
    assert model.NAME == pruned.NAME == "DART"
    assert 0 < pruned.ensemble.num_trees < model.ensemble.num_trees
    ptrain, train = read_svml(str(d / "ptrain.svml")), read_svml(str(svml_dir / "train.svml"))
    assert ptrain.features.shape == (train.num_docs, model.ensemble.num_trees)
    test = svml_dir / "test.svml"
    assert _ndcg10(test, d / "s.txt") == pytest.approx(_ndcg10(test, outs[0] / "s.txt"),
                                                        abs=1e-2)
