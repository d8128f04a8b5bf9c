"""The port's code generators (quickrank_tpu_torch/io/codegen.py), the
driver's codegen phase and its ``--trace`` phase, on the CPU.

For one model loaded by both packages from the same XML file, the port's
``condop``, ``oblivious`` and ``vpred`` output is the JAX package's byte for
byte; the compiled ``condop`` and ``oblivious`` programs score the model's
``score_dataset`` within 1e-5."""

import io
import json
import subprocess
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from quickrank_tpu.cli import main as jax_main
from quickrank_tpu.io import codegen as jax_codegen
from quickrank_tpu.learning.base import LTRAlgorithm as JaxLTRAlgorithm
from quickrank_tpu_torch.cli import main as port_main
from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.data.svml import write_svml
from quickrank_tpu_torch.io import codegen
from quickrank_tpu_torch.learning import LambdaMart, ObliviousMart
from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.metrics import Ndcg
from quickrank_tpu_torch.utils import phase_timer

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

#: model -> the generators that take it (``oblivious`` needs symmetric trees)
CASES = [("mart", "condop"), ("mart", "vpred"), ("obv", "condop"), ("obv", "oblivious"),
         ("obv", "vpred")]


def _port_ds(d):
    return Dataset(d.features, d.labels, d.query_offsets, d.qids)


@pytest.fixture(scope="module")
def models(splits, tmp_path_factory):
    """XML paths of a best-first LambdaMART (8 leaves) and an oblivious MART
    (depth 3), 5 trees each, trained by the port."""
    d = tmp_path_factory.mktemp("codegen")
    train = _port_ds(splits[0])
    paths = {}
    for name, model in (("mart", LambdaMart(ntrees=5, nleaves=8, nthresholds=32, seed=1)),
                        ("obv", ObliviousMart(ntrees=5, treedepth=3, nthresholds=32, seed=1))):
        model.learn(train, None, Ndcg(10), verbose=False, device="cpu")
        paths[name] = str(d / f"{name}.xml")
        model.save(paths[name])
    return paths


@pytest.mark.parametrize("name,generator", CASES)
def test_generated_code_is_jax_byte_for_byte(models, name, generator):
    path = models[name]
    got = codegen.generate(LTRAlgorithm.load(path), generator)
    assert got == jax_codegen.generate(JaxLTRAlgorithm.load(path), generator)
    assert len(got) > 100


def _compile_and_score(code: str, X: np.ndarray, tmp):
    """Compile ``code`` with a main that reads rows from stdin and prints
    ``ranker(v)`` for each; the scores of ``X``."""
    src = tmp / "ranker.c"
    src.write_text(code + """
#include <stdio.h>
#include <stdlib.h>
int main(void) {
    int n, f;
    if (scanf("%d %d", &n, &f) != 2) return 1;
    float *v = malloc(sizeof(float) * f);
    for (int i = 0; i < n; ++i) {
        for (int j = 0; j < f; ++j) if (scanf("%f", &v[j]) != 1) return 1;
        printf("%.10g\\n", ranker(v));
    }
    return 0;
}
""")
    exe = tmp / "ranker"
    subprocess.run(["gcc", "-O1", "-o", str(exe), str(src), "-lm"], check=True)
    rows = [f"{X.shape[0]} {X.shape[1]}"] + [
        " ".join(np.format_float_positional(v, unique=True) for v in row) for row in X]
    out = subprocess.run([str(exe)], input="\n".join(rows), capture_output=True, text=True,
                         check=True)
    return np.asarray([float(x) for x in out.stdout.split()])


@pytest.mark.parametrize("name,generator", [("mart", "condop"), ("obv", "oblivious")])
def test_compiled_code_scores_the_model(models, splits, tmp_path, name, generator):
    model = LTRAlgorithm.load(models[name])
    test = _port_ds(splits[2])
    X = test.features[:64]
    got = _compile_and_score(codegen.generate(model, generator), X, tmp_path)
    want = model.score_dataset(test, device="cpu")[:64]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_stablehlo_generator_is_refused(models):
    """stablehlo is refused with the reason and the pointer to pt2."""
    with pytest.raises(NotImplementedError,
                       match="StableHLO is written by jax.export.*--generator pt2"):
        codegen.generate(LTRAlgorithm.load(models["mart"]), "stablehlo")
    with pytest.raises(ValueError, match="unknown generator"):
        codegen.generate(LTRAlgorithm.load(models["mart"]), "nosuch")


def test_pt2_generator_points_to_export(models):
    """pt2 is an archive that io/export.py writes as bytes, not C source."""
    with pytest.raises(ValueError, match="torch.export archive.*export_scorer"):
        codegen.generate(LTRAlgorithm.load(models["mart"]), "pt2")


@pytest.mark.parametrize("generator", ["condop", "oblivious", "vpred"])
def test_cli_codegen_phase_writes_jax_bytes(models, tmp_path, generator):
    """quicklearn --model-file --code-file --generator: the file the JAX
    CLI writes from the same model."""
    model = models["obv"]
    port, jax = tmp_path / "port.c", tmp_path / "jax.c"
    with redirect_stdout(io.StringIO()) as out:
        assert port_main(["--model-file", model, "--code-file", str(port), "--generator",
                          generator, "--device", "cpu"]) == 0
        assert jax_main(["--model-file", model, "--code-file", str(jax), "--generator",
                         generator]) == 0
    assert f"# {generator} code saved to {port}" in out.getvalue()
    assert port.read_bytes() == jax.read_bytes()


def test_cli_trace_writes_a_chrome_trace(splits, tmp_path):
    """--trace DIR wraps the training phase in torch.profiler and writes a
    Chrome trace holding the phase's operators; the phase timings are kept."""
    write_svml(_port_ds(splits[0]), str(tmp_path / "train.svml"))
    with redirect_stdout(io.StringIO()) as out:
        assert port_main(["--algo", "MART", "--train", str(tmp_path / "train.svml"),
                          "--num-trees", "2", "--num-leaves", "4", "--num-thresholds", "16",
                          "--trace", str(tmp_path / "trace"), "--device", "cpu"]) == 0
    traces = list((tmp_path / "trace").glob("*.trace.json"))
    assert len(traces) == 1
    assert f"trace of the training phase written to {traces[0]}" in out.getvalue()
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert "phase timings: load-data=" in out.getvalue() and " train=" in out.getvalue()


def test_phase_timer_adds_into_its_sink():
    sink = {}
    with redirect_stdout(io.StringIO()) as out:
        for _ in range(2):
            with phase_timer("x", sink=sink):
                pass
    assert set(sink) == {"x"} and sink["x"] >= 0.0
    assert out.getvalue().count("# [x]") == 2
