"""The port's RankBoost (quickrank_tpu_torch/learning/rankboost.py) against
the JAX package's, on the CPU.

The factorized potentials follow JAX's arithmetic (XLA's cumsum order
through ``prefix_sum``, the scatter-add histogram in dataset order), but
``exp`` differs from XLA's in the last bit, so ``pi`` and ``S`` are held to
1e-6, and a run to the weak rankers JAX picks, its alphas within 1e-5 and
its NDCG@10 within 1e-4.  A model loaded from one XML file scores JAX's bits.
The card's arithmetic (one ``torch.cumsum`` a scan, K4's fixed-point sums,
emulated here by ``node_histogram_fixed``) is held to the same outcome."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quickrank_tpu.data.dataset import Dataset as JaxDataset
from quickrank_tpu.data.synthetic import make_ranking_dataset, make_train_valid_test
from quickrank_tpu.learning.base import LTRAlgorithm as JaxLTRAlgorithm
from quickrank_tpu.learning.mart import TrainData as JaxTrainData
from quickrank_tpu.learning.rankboost import RankBoost as JaxRankBoost
from quickrank_tpu.learning.rankboost import pair_potentials as jax_pair_potentials
from quickrank_tpu.metrics import Ndcg as JaxNdcg
from quickrank_tpu.optimization import cleaver as JC
from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.learning import rankboost
from quickrank_tpu_torch.learning.base import LTRAlgorithm
from quickrank_tpu_torch.learning.mart import TrainData
from quickrank_tpu_torch.learning.rankboost import RankBoost, pair_potentials
from quickrank_tpu_torch.metrics import Ndcg
from quickrank_tpu_torch.ops import kernel_histogram
from quickrank_tpu_torch.optimization import cleaver as PC

torch.set_num_threads(1)  # the suite's workers share the host's cores: one thread each

ROUNDS = 12


def _port_ds(d):
    return Dataset(d.features, d.labels, d.query_offsets, d.qids)


@pytest.fixture(scope="module")
def folds():
    return make_train_valid_test(num_queries=(30, 10, 10))


@pytest.fixture(scope="module")
def runs(folds):
    """(JAX model, history), (port model, history): 12 rounds, 32 thresholds."""
    train, valid, _ = folds
    j = JaxRankBoost(ntrees=ROUNDS, nthresholds=32)
    jh = j.learn(train, valid, JaxNdcg(10), verbose=False)
    p = RankBoost(ntrees=ROUNDS, nthresholds=32)
    ph = p.learn(_port_ds(train), _port_ds(valid), Ndcg(10), verbose=False, device="cpu")
    return (j, jh), (p, ph)


@pytest.fixture(scope="module")
def step_data(folds):
    train = folds[0]
    return JaxTrainData.build(train, 32), TrainData.build(_port_ds(train), 32, device="cpu")


def _levels(ds):
    return tuple(float(x) for x in np.unique(ds.labels))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_potentials_match_jax(folds, step_data, seed):
    """S within 1e-6 relative, pi within 1e-6 * max|pi|, and the same weak
    ranker, on cumulative scores like a mid-training round's."""
    jt, pt = step_data
    levels = _levels(folds[0])
    rng = np.random.default_rng(seed)
    s = (rng.normal(0, 2.0, pt.padded.num_docs_padded).astype(np.float32)
         * pt.padded.doc_mask.numpy())
    jf, jtt, jr, jS, jpi = jax_pair_potentials(jnp.asarray(s), jt.step, levels, jt.num_bins)
    f, t, r, S, pi = pair_potentials(torch.from_numpy(s), pt.step, levels, pt.num_bins,
                                     pt.num_real_features)
    np.testing.assert_allclose(float(S), float(jS), rtol=1e-6)
    jpi = np.asarray(jpi)
    np.testing.assert_allclose(pi.numpy(), jpi, rtol=0, atol=1e-6 * np.abs(jpi).max())
    assert (int(f), int(t)) == (int(jf), int(jtt))
    np.testing.assert_allclose(float(r), float(jr), rtol=1e-5)


def _dense_oracle(sd, s_flat, num_bins):
    """pi, S and r read off the materialized D(i, j) = exp(s_i - s_j) *
    pair_mask / S of every query, in float64 (the reference's form)."""
    pad_index, sm = sd.pad_index.numpy(), sd.slot_mask.numpy()
    sp = np.where(sm, s_flat[pad_index], 0.0).astype(np.float64)
    lp = sd.labels.numpy()[pad_index]
    Q, Dm = sp.shape
    ii, jj = np.arange(Dm)[:, None], np.arange(Dm)[None, :]
    Ds = []
    for q in range(Q):
        mask = (ii < jj) & sm[q][:, None] & sm[q][None, :] & (lp[q][None, :] > lp[q][:, None])
        Ds.append(np.where(mask, np.exp(sp[q][:, None] - sp[q][None, :]), 0.0))
    S = sum(Dq.sum() for Dq in Ds)
    pi_p = np.stack([Dq.sum(axis=0) / S - Dq.sum(axis=1) / S for Dq in Ds])
    dm = sd.doc_mask.numpy()
    pi = np.zeros(len(dm))
    pi[dm] = pi_p[sd.inv_q.numpy()[dm], sd.inv_slot.numpy()[dm]]
    binned = sd.binned.numpy().astype(np.int64)
    r = np.asarray([[pi[dm & (binned[:, f] > t)].sum() for t in range(num_bins)]
                    for f in range(binned.shape[1])])
    return pi, S, r


def test_factorized_potentials_match_dense_oracle():
    ds = _port_ds(make_ranking_dataset(num_queries=6, num_features=5, avg_docs_per_query=30,
                                       seed=7))
    tr = TrainData.build(ds, 16, device="cpu")
    rng = np.random.default_rng(0)
    s = (rng.normal(0, 2.0, tr.padded.num_docs_padded).astype(np.float32)
         * tr.padded.doc_mask.numpy())
    f, t, r, S, pi = pair_potentials(torch.from_numpy(s), tr.step, _levels(ds), tr.num_bins,
                                     tr.num_real_features)
    pi_o, S_o, r_o = _dense_oracle(tr.step, s, tr.num_bins)
    np.testing.assert_allclose(float(S), S_o, rtol=1e-6)
    np.testing.assert_allclose(pi.numpy(), pi_o, rtol=0, atol=1e-6)
    assert (int(f), int(t)) == np.unravel_index(np.argmax(r_o[: ds.num_features]), r_o.shape)
    np.testing.assert_allclose(float(r), r_o.max(), rtol=1e-5)


def test_weak_rankers_match_jax(runs):
    """The first ten weak rankers (feature, threshold) equal, alphas within
    1e-5 relative, train and valid NDCG@10 within 1e-4 every round."""
    (j, jh), (p, ph) = runs
    assert ph["best_T"] == jh["best_T"] >= 10
    np.testing.assert_array_equal(p.features_[:10], j.features_[:10])
    np.testing.assert_array_equal(p.thetas_[:10], j.thetas_[:10])
    np.testing.assert_allclose(p.alphas_, j.alphas_, rtol=1e-5)
    np.testing.assert_allclose(ph["train"], jh["train"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ph["valid"], jh["valid"], rtol=0, atol=1e-4)


def test_host_syncs_per_round(folds):
    """Two host reads a round: (argmax, r, S), then the train and valid
    metrics together."""
    train, valid, _ = folds
    rankboost.HOST_SYNCS = 0
    RankBoost(ntrees=3, nthresholds=16).learn(_port_ds(train), _port_ds(valid), Ndcg(10),
                                              verbose=False, device="cpu")
    assert rankboost.HOST_SYNCS == 6


def test_jax_model_scores_bitwise_in_port(runs, folds, tmp_path):
    """A JAX-saved model scores JAX's bits (the numpy product on the CPU),
    per weak ranker too; the port's XML loads in JAX with the same fields."""
    (j, _), (p, _) = runs
    test = folds[2]
    path = str(tmp_path / "rb.xml")
    j.save(path)
    loaded = LTRAlgorithm.load(path)
    assert loaded.scorer_path() == "rankboost"
    got = loaded.score_dataset(_port_ds(test), device="cpu")
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, j.score_dataset(test))
    np.testing.assert_array_equal(loaded.partial_scores_dataset(_port_ds(test), device="cpu"),
                                  j.partial_scores_dataset(test).astype(np.float32))
    p.save(path)
    back = JaxLTRAlgorithm.load(path)
    for name in ("features_", "thetas_", "signs_", "alphas_"):
        np.testing.assert_array_equal(getattr(back, name), getattr(p, name))
    assert back.T == p.T and back.best_T == p.best_T


def test_cleaver_prunes_a_rankboost_model_as_jax(runs, folds, tmp_path):
    """Cleaver's QUALITY_LOSS on one loaded RankBoost model prunes JAX's set
    (``partial_scores_dataset``, ``get_weights`` and ``update_weights``)."""
    (j, _), _ = runs
    train, valid, _ = folds
    path = str(tmp_path / "rb.xml")
    j.save(path)
    jm, pm = JaxLTRAlgorithm.load(path), LTRAlgorithm.load(path)
    JC.Cleaver("QUALITY_LOSS", 0.5).optimize(jm, train, valid, JaxNdcg(10), verbose=False)
    PC.Cleaver("QUALITY_LOSS", 0.5).optimize(pm, _port_ds(train), _port_ds(valid), Ndcg(10),
                                             verbose=False, device="cpu")
    np.testing.assert_array_equal(pm.alphas_ == 0, jm.alphas_ == 0)
    np.testing.assert_allclose(pm.alphas_, jm.alphas_, rtol=1e-6)


def test_card_arithmetic_gives_the_same_outcome(folds, monkeypatch):
    """The card's path, emulated on the CPU: every scan one ``torch.cumsum``
    and the potential histogram K4's fixed-point sums under the run's scale
    (``node_histogram_fixed_int``, which the kernel equals bit for bit).  The
    first five weak rankers are the CPU path's and the train NDCG@10 within
    1e-3 (``chip_smoke.py`` phase 28 holds the card itself so)."""
    train = _port_ds(folds[0])
    cpu = RankBoost(ntrees=8, nthresholds=32)
    hc = cpu.learn(train, None, Ndcg(10), verbose=False, device="cpu")

    def fixed(binned, pi, doc_mask, num_bins, f_used=0, group=None, num_docs=0):
        # the card's scale: pi's max bits and the run's real docs
        vt = torch.where(doc_mask, pi, 0.0)[None, :].contiguous()
        pos = torch.where(doc_mask, 0, 1).to(torch.int32)
        bits = kernel_histogram.channel_max_bits(vt)
        acc = kernel_histogram.node_histogram_fixed_int(binned, vt, pos, num_bins, 0, 1, bits,
                                                        num_docs, f_used)
        return kernel_histogram.fixed_to_float(acc, bits, num_docs)[:, :, 0]

    monkeypatch.setattr(rankboost, "_scan", torch.cumsum)
    monkeypatch.setattr(rankboost, "potential_histogram", fixed)
    card = RankBoost(ntrees=8, nthresholds=32)
    hk = card.learn(train, None, Ndcg(10), verbose=False, device="cpu")
    np.testing.assert_array_equal(card.features_[:5], cpu.features_[:5])
    np.testing.assert_array_equal(card.thetas_[:5], cpu.thetas_[:5])
    assert abs(hk["train"][-1] - hc["train"][-1]) <= 1e-3


def test_no_discordant_pairs_is_finite():
    """Every query's docs share one label: S = 0, so alpha is 0, not NaN."""
    rng = np.random.default_rng(0)
    n_q, dpq = 8, 10
    feats = rng.standard_normal((n_q * dpq, 6)).astype(np.float32)
    labels = np.repeat(np.arange(n_q) % 3, dpq).astype(np.float32)
    ds = Dataset.from_arrays(feats, labels, np.repeat(np.arange(1, n_q + 1), dpq))
    rb = RankBoost(ntrees=4, nthresholds=16)
    info = rb.learn(ds, None, Ndcg(10), verbose=False, device="cpu")
    assert np.isfinite(info["train"]).all()
    assert np.allclose(rb.alphas_, 0.0)
    assert np.isfinite(rb.score_dataset(ds, device="cpu")).all()


def test_refusals():
    """More than 64 label levels (JAX's message) and a mesh that is neither
    a DataGroup nor a Mesh2D."""
    rng = np.random.default_rng(1)
    ds = Dataset.from_arrays(rng.standard_normal((130, 3)).astype(np.float32),
                             np.arange(130, dtype=np.float32), np.repeat([1, 2], 65))
    with pytest.raises(ValueError, match="130 distinct labels"):
        RankBoost(ntrees=1).learn(ds, device="cpu", verbose=False)
    with pytest.raises(NotImplementedError, match="DataGroup .* or a parallel.mesh.Mesh2D"):
        RankBoost(ntrees=1).learn(ds, device="cpu", mesh=object())
    jds = JaxDataset.from_arrays(ds.features, ds.labels, np.repeat([1, 2], 65))
    with pytest.raises(ValueError, match="130 distinct labels"):
        JaxRankBoost(ntrees=1).learn(jds, verbose=False)
