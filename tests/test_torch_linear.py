"""The port's linear rankers (quickrank_tpu_torch/learning/linear.py) against
the JAX package's CoordinateAscent and LineSearch, on the CPU.

Bitwise: ``X @ w`` in XLA's order, the candidate grids and the candidate
score matrices (XLA rewrites ``2 * window / P`` and fuses ``presum + pts *
col``; the port repeats both).  Within 1e-6: the metric of every candidate
of a step, given the same weights; the point chosen is JAX's wherever the
best and second-best metrics, and the current one, are more than 1e-6
apart.  Whole 3-epoch runs are held to a final-quality band."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quickrank_tpu.data.dataset import shard_and_pad as jax_shard_and_pad
from quickrank_tpu.data.synthetic import make_train_valid_test
from quickrank_tpu.io import xml_model as jax_xml
from quickrank_tpu.learning import linear as JL
from quickrank_tpu.metrics import Ndcg as JaxNdcg
from quickrank_tpu_torch import quickscore
from quickrank_tpu_torch.data.svml import write_svml
from quickrank_tpu_torch.io import xml_model
from quickrank_tpu_torch.learning import linear as PL
from quickrank_tpu_torch.metrics import Ndcg
from quickrank_tpu_torch.ops.scoring import matvec_f32

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

F = 10
TOL = 1e-6


@pytest.fixture(scope="module")
def folds():
    return make_train_valid_test(num_queries=(24, 12, 12), avg_docs_per_query=20,
                                 num_features=F, seed=7)


@pytest.fixture(scope="module")
def jax_fold(folds):
    padded = jax_shard_and_pad(folds[0])
    return padded, padded.features


def _weights(seed):
    w = np.random.default_rng(seed).uniform(0.2, 1.0, F).astype(np.float32)
    return w / w.sum()


@pytest.mark.parametrize("T", [4, 10, 136])
def test_matvec_is_xla_dot_bitwise(T):
    rng = np.random.default_rng(T)
    X = rng.standard_normal((777, T), dtype=np.float32)
    w = rng.standard_normal(T, dtype=np.float32)
    want = np.asarray(jax.jit(lambda a, b: a @ b)(X, w))
    got = matvec_f32(torch.from_numpy(X), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)


def test_candidate_matrices_bitwise():
    """Given the same inputs, the grid, step 1's and step 2's candidate
    matrices and step 2's chosen weights are JAX's jitted expressions bit
    for bit."""
    rng = np.random.default_rng(3)
    N = 500
    full, col, dscore = (rng.standard_normal(N, dtype=np.float32) for _ in range(3))
    w, w_prev = (rng.uniform(0, 1, F).astype(np.float32) for _ in range(2))
    for P in (21, 20, 6):
        # inside the epoch's loop over features ``step * i`` does not
        # depend on the feature and is hoisted out of it, so the add after it
        # is not contracted: the grids are built in such a loop here too
        def grid(ws, window, P=P):
            def body(k, out):
                pts = ws[k] - window + (2.0 * window / P) * jnp.arange(P + 1, dtype=jnp.float32)
                return out.at[k].set(pts)
            return jax.lax.fori_loop(0, ws.shape[0], body, jnp.zeros((ws.shape[0], P + 1)))

        grid = jax.jit(grid)
        step1 = jax.jit(lambda full, col, wi, pts:
                        (full - wi * col)[None, :] + pts[:, None] * col[None, :])
        step2 = jax.jit(lambda base, d, P=P:
                        base[None, :] + jnp.arange(P + 1, dtype=jnp.float32)[:, None] * d[None, :])
        point = jax.jit(lambda w, wp, b, P=P:
                        wp + ((w - wp) / P) * jnp.arange(P + 1, dtype=jnp.float32)[b])
        for window in (0.5, 1.0 / 136, 10.0 * 0.95 ** 7):
            window = np.float32(window)
            ws = np.concatenate([w, [0.37, 0.013, 1.0]]).astype(np.float32)
            jgrid = np.asarray(grid(ws, window))
            for wi, jpts in zip(ws, jgrid):
                np.testing.assert_array_equal(PL.grid_points(wi, window, P), jpts)
            wi = ws[-2]
            pts = PL.grid_points(wi, window, P)
            got = PL.feature_candidates(torch.from_numpy(full), torch.from_numpy(col), wi, pts)
            np.testing.assert_array_equal(got.numpy(), np.asarray(step1(full, col, wi, pts)))
        got = PL.joint_candidates(torch.from_numpy(full), torch.from_numpy(dscore), P)
        np.testing.assert_array_equal(got.numpy(), np.asarray(step2(full, dscore)))
        for b in (0, 1, P // 2, P):
            np.testing.assert_array_equal(PL.joint_point(w, w_prev, b, P),
                                          np.asarray(point(w, w_prev, b)))


def _jax_step(metric, P):
    """JAX's feature step (linear.py:200-212) with its candidate metrics
    exposed: (pts, ms, current) for weights ``w`` moved at feature ``i``.
    ``step * i`` is computed apart, as the epoch hoists it out of its loop."""
    offsets = jax.jit(lambda window: (2.0 * window / P) * jnp.arange(P + 1, dtype=jnp.float32))

    def step(w, w_from, i, window, off, X, padded):
        col = jax.lax.dynamic_index_in_dim(X, i, 1, keepdims=False)
        full = X @ w_from
        wi = w_from[i]
        presum = full - wi * col
        current = JL.eval_padded_local(metric, padded, X @ w)
        pts = wi - window + off
        cands = presum[None, :] + pts[:, None] * col[None, :]
        ms = JL._LinearRanker._metric_batch(metric, padded, cands)
        return pts, jnp.where(pts >= 0, ms, -jnp.inf), current

    jstep = jax.jit(step)
    return lambda w, w_from, i, window, X, padded: jstep(w, w_from, i, window, offsets(window),
                                                          X, padded)


def _check_step(pts, ms, jpts, jms, current, chosen, tag):
    """Candidate metrics within TOL; the chosen point JAX's where decidable.
    Returns whether the step was decidable."""
    np.testing.assert_array_equal(pts, np.asarray(jpts), tag)
    jms = np.asarray(jms)
    np.testing.assert_array_equal(np.isfinite(ms), np.isfinite(jms), tag)
    fin = np.isfinite(ms)
    assert np.abs(ms[fin] - jms[fin]).max(initial=0.0) <= TOL, tag
    top = np.sort(jms[fin])[::-1]
    if top.size < 2 or top[0] - top[1] <= TOL or abs(top[0] - current) <= TOL:
        return False
    b = int(np.argmax(jms))
    assert chosen == (pts[b] if jms[b] > current else None), tag
    return True


def test_coordinate_ascent_step_metrics_match_jax(folds, jax_fold):
    """Every feature step of an epoch from the same weights: the candidate
    metrics within 1e-6 and JAX's choice where the margins allow one."""
    ca = PL.CoordinateAscent()
    fold = PL.Fold(folds[0], "cpu")
    step = _jax_step(JaxNdcg(10), ca.num_points)
    padded, X = jax_fold
    decided = 0
    for seed in (0, 1):
        w = _weights(seed)
        window = np.float32(10.0 / F * 0.95 ** seed)
        for i in range(F):
            w_new, pts, ms, (_, current) = ca.feature_step(fold, Ndcg(10), w, i, window)
            jpts, jms, jcur = step(w, w, i, window, X, padded)
            assert abs(current - float(jcur)) <= TOL
            chosen = None if w_new is w else pts[int(np.argmax(ms))]
            decided += _check_step(pts, ms, jpts, jms, float(jcur), chosen, f"{seed}/{i}")
            w = w_new
    assert decided >= F


def test_line_search_iteration_metrics_match_jax(folds, jax_fold):
    """Step 1's per-feature metrics (from w_prev, against the global best)
    and step 2's joint-search metrics within 1e-6 of JAX's, given the same
    weights."""
    ls = PL.LineSearch()
    P = ls.grid_size
    fold = PL.Fold(folds[0], "cpu")
    padded, X = jax_fold
    step = _jax_step(JaxNdcg(10), P)
    joint = jax.jit(lambda w, wp, X, padded: JL._LinearRanker._metric_batch(
        JaxNdcg(10), padded,
        (X @ wp)[None, :] + jnp.arange(P + 1, dtype=jnp.float32)[:, None]
        * (X @ ((w - wp) / P))[None, :]))
    w_prev = np.ones(F, np.float32)
    best = np.float32(fold.metric(Ndcg(10), fold.dot(w_prev)))
    trace = []
    w, _, _, _ = ls.iteration(fold, Ndcg(10), w_prev.copy(), w_prev, best, np.float32(10.0),
                              trace=trace)
    decided = 0
    for f, (pts, ms) in enumerate(trace[:F]):
        jpts, jms, _ = step(w_prev, w_prev, f, np.float32(10.0), X, padded)
        chosen = pts[int(np.argmax(ms))] if ms.max() > best else None
        decided += _check_step(pts, ms, jpts, jms, float(best), chosen, f"feature {f}")
    assert decided >= F // 2
    w1 = w_prev.copy()
    for f, (pts, ms) in enumerate(trace[:F]):
        if ms.max() > best:
            w1[f] = pts[int(np.argmax(ms))]
    ms2 = trace[F][1]
    jms2 = np.asarray(joint(w1, w_prev, X, padded))
    assert np.abs(ms2 - jms2).max() <= TOL


@pytest.mark.parametrize("cls,n", [("CoordinateAscent", 1), ("CoordinateAscent", 0),
                                   ("LineSearch", 1), ("LineSearch", -3)])
def test_num_points_guard(cls, n):
    for mod in (JL, PL):
        with pytest.raises(ValueError, match="at least 2 grid points"):
            getattr(mod, cls)(num_points=n)


def test_imported_weights_size_is_checked(folds):
    messages = []
    for mod, kw in ((JL, {}), (PL, {"device": "cpu"})):
        ls = mod.LineSearch(max_iterations=1)
        ls.update_weights(np.ones(F + 1))
        with pytest.raises(ValueError, match="imported weights size") as e:
            ls.learn(folds[0], None, (JaxNdcg if mod is JL else Ndcg)(10), verbose=False, **kw)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


RUNS = {
    "ca": ("CoordinateAscent", {}, None),
    "ls": ("LineSearch", {}, None),
    "ls-adaptive": ("LineSearch", {"adaptive": True}, None),
    "ls-train-only-last": ("LineSearch", {"train_only_last": 4}, 2.0),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_three_epoch_runs_track_jax(folds, run):
    """Whole runs: train and valid NDCG@10 per epoch within 1e-2 of JAX's
    (the band of chaotic trajectories; on these folds the weights have come
    out bitwise equal).  ``train_only_last`` moves only the last features."""
    name, kw, w0 = RUNS[run]
    train, valid, test = folds
    models = []
    for mod, metric, dev in ((JL, JaxNdcg(10), {}), (PL, Ndcg(10), {"device": "cpu"})):
        m = getattr(mod, name)(max_iterations=3, **kw)
        if w0 is not None:
            m.update_weights(np.full(F, w0))
        models.append((m, m.learn(train, valid, metric, verbose=False, **dev)))
    (j, jh), (p, ph) = models
    assert len(ph["train"]) == len(jh["train"]) == 3
    np.testing.assert_allclose(ph["train"], jh["train"], rtol=0, atol=1e-2)
    np.testing.assert_allclose(ph["valid"], jh["valid"], rtol=0, atol=1e-2)
    assert ph["train"][-1] > 0.5
    if name == "CoordinateAscent":
        assert p.best_weights.sum() == pytest.approx(1.0, abs=1e-3)
    if w0 is not None:
        for m in (j, p):
            assert np.all(m.best_weights[:F - 4] == w0)


@pytest.mark.parametrize("name", ["CoordinateAscent", "LineSearch"])
def test_xml_across_packages(tmp_path, name):
    """A model saved by either package loads in the other with the same
    weights, and both write the same bytes."""
    w = np.random.default_rng(5).standard_normal(F)
    pm, jm = getattr(PL, name)(num_points=11, window_size=3.5), getattr(JL, name)(
        num_points=11, window_size=3.5)
    pm.update_weights(w)
    jm.update_weights(w)
    ppath, jpath = str(tmp_path / "port.xml"), str(tmp_path / "jax.xml")
    pm.save(ppath)
    jax_xml.save_model(jm, jpath)
    with open(ppath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    jl, pl = jax_xml.load_model(ppath), xml_model.load_model(jpath)
    assert type(pl) is type(pm) and type(jl) is type(jm)
    np.testing.assert_array_equal(jl.best_weights, w)
    np.testing.assert_array_equal(pl.best_weights, w)
    assert (pl.num_points, pl.window_size) == (11, 3.5)


def test_linear_scores_and_quickscore(folds, tmp_path):
    """``score_dataset`` (float64 ``X @ w``) within 1e-12 relative of JAX's
    numpy scores, and quickscore serves the saved model on the linear path."""
    test = folds[2]
    w = np.random.default_rng(8).standard_normal(F)
    j, p = JL.CoordinateAscent(), PL.CoordinateAscent()
    j.update_weights(w)
    p.update_weights(w)
    want = j.score_dataset(test)
    got = p.score_dataset(test, device="cpu")
    assert got.dtype == np.float64 and p.scorer_path() == "linear"
    assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())
    data, model, out = (str(tmp_path / n) for n in ("t.svml", "ca.xml", "s.txt"))
    write_svml(test, data)
    p.save(model)
    assert quickscore.main(["-d", data, "-m", model, "-r", "2", "--device", "cpu",
                            "-s", out]) == 0
    np.testing.assert_array_equal(np.loadtxt(out), [float(f"{x:.15g}") for x in got])


def test_mesh_refused(folds):
    for ranker in (PL.CoordinateAscent(), PL.LineSearch()):
        with pytest.raises(NotImplementedError,
                           match="DataGroup .* or a parallel.mesh.Mesh2D"):
            ranker.learn(folds[0], mesh=object(), device="cpu")
