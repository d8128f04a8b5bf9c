"""RankBoost, pairwise boosting of binary threshold weak rankers
(counterpart of quickrank_tpu/learning/rankboost.py, after
src/learning/forests/rankboost.cc).

The reference keeps per-query pair-weight matrices ``D[q][i][j]``
(rankboost.cc:276-292) and updates them multiplicatively every round
(rankboost.cc:419-445).  That tensor is O(Q * Dmax^2), so, as in the JAX
package, it is never built: the update is separable,

    D_t(i, j)  ∝  exp(s_i - s_j) * pair_mask(i, j),

with ``s`` the cumulative weak-ranker score, and every quantity a round reads
off D factorizes:

  * the potential ``pi(d) = sum_j D(j, d) - sum_j D(d, j)``
    (rankboost.cc:349-361) is ``exp(-s_d) * col(d) - exp(s_d) * row(d)``,
    where ``row`` and ``col`` are per-query suffix and prefix sums of
    ``exp(±s)`` over the docs of each other label level;
  * the normalizer ``Z_t`` is the ratio ``S_t / S_{t-1}`` of consecutive
    pair-exponential sums ``S_t = sum_pairs exp(s_i - s_j)``;
  * the weak-ranker search (rankboost.cc:365-415) is a histogram of ``pi``
    over (feature, bin) and a suffix sum along the bins:
    ``r(f, t) = sum of pi over docs with bin(doc, f) > t``, maximized by one
    argmax.  On the card the histogram is the node-histogram kernel (K4,
    ``ops/kernel_histogram.py``) with the single channel ``pi``; on the CPU
    the scatter-add of ``ops/histogram.py``, in the JAX package's CPU order.

Scans.  On the CPU the slot-axis and bin-axis scans are
``ops/histogram.py::prefix_sum``, the order in which XLA on the CPU
evaluates ``jnp.cumsum``, so the potentials and the search follow the JAX
package's arithmetic (``exp`` differs from XLA's in the last bit, so the
potentials are held to a tolerance, not bitwise).  On a CUDA tensor each
scan is one ``torch.cumsum``, the card's order since RankBoost was ported
(``prefix_sum`` is one launch there too, in XLA's order, but taking it would
change the card's arithmetic).

Reference semantics kept: pairs (i, j) with i < j in dataset order and
label_j > label_i; alpha = 0.5 ln((z + r)/(z - r)) with the r >= 1 escape
``alpha = max_alpha * r`` (rankboost.cc:150-160); h(x) = [x[f] > theta]; the
model truncated to the best round on the validation fold.  The factorized
exponentials are float32 after a per-query recentering and a ±20 clamp on
the centered scores (the JAX package's deviation from the reference's
doubles).

Host traffic a round: one transfer of (f*, t*, best r, S) and one of the
train and valid metrics (``HOST_SYNCS`` counts them).

Query-sharded training (``learn(mesh=group)``, a ``parallel.DataGroup``; JAX
rankboost.py:151-230): every rank runs the rounds on its block of the
queries.  ``S`` is a sum of per-query sums (``metrics/core.py::query_sum``,
a fixed order on the card) gathered in global query order and summed as one
rank sums them; the potential histogram is K4's int64 sums under one scale
a round (the ranks' max bits and the run's real docs), reduced over the
ranks before the conversion; the train metric is the gathered per-query
reduction.  So every rank picks one rank's weak ranker and alpha, bit for
bit on the card (on the CPU the float histograms of two ranks add in
another order than one's).  The validation fold stays whole on every rank.
Rank 0 alone prints.

The trained model scores ``sum_t alpha_t [x[f_t] > theta_t]``: a column
gather, a compare and a float64 matrix-vector product (the JAX package's
numpy expression on the CPU, bit for bit; ``torch.matmul`` on the card).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from quickrank_tpu_torch.data.dataset import (
    Dataset,
    PaddedDataset,
    gather_padded,
    shard_and_pad,
)
from quickrank_tpu_torch.learning.base import LTRAlgorithm, resolve_device
from quickrank_tpu_torch.learning.mart import StepData, TrainData, eval_metric, refuse_mesh
from quickrank_tpu_torch.metrics.core import query_sum
from quickrank_tpu_torch.ops.binning import bin_columns
from quickrank_tpu_torch.ops.histogram import (
    histogram_scale,
    masked_histogram_scatter,
    masked_histogram_t,
    prefix_sum,
)

#: centered-score clamp: exp is bounded by e^20, a product of two by e^40,
#: and S (a sum over ~1e7 pairs) by ~1e27, inside float32
_SCORE_CLAMP = 20.0
_MAX_LABEL_LEVELS = 64
#: JAX's refusal of a 2-D mesh (rankboost.py:156-159), with its reason
#: (PARITY.md "known exclusions")
ONE_D = ("RANKBOOST supports 1-D (data) meshes only: its weak-ranker search is "
         "already feature-vectorized per shard (PARITY.md known exclusions)")
#: docs a block of the card's scoring product holds (bounds its [docs, T]
#: float64 bit matrix to 256 MB at 256 weak rankers)
_SCORE_BLOCK_CELLS = 1 << 25

#: host reads of device values by :meth:`RankBoost.learn`; a run that counts
#: them sets this to 0 first
HOST_SYNCS = 0


def _scan(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum along ``dim``: XLA's CPU order on the CPU, one
    ``torch.cumsum`` on the card."""
    if x.device.type == "cuda":
        return torch.cumsum(x, dim)
    return prefix_sum(x, dim)


def potentials(s_flat: torch.Tensor, sd: StepData, levels: tuple, group=None):
    """``(pi, S)``: the flat ``[N]`` per-doc potential of the implicit
    pair-weight matrix ``D(i, j) = exp(s_i - s_j) * pair_mask / S`` and the
    pair-exponential sum ``S`` (0-d), in O(Q * Dm * len(levels)) work
    (JAX rankboost.py:86-119).  ``levels`` are the sorted distinct labels.
    ``S`` is the sum of the per-query sums, under ``group`` over every
    rank's real queries gathered in global order (``sd.queries``) as
    ``learning/mart.py::reduce_queries`` sums a metric, so that it is one
    rank's value bit for bit (JAX psums the ranks' float sums)."""
    mask = sd.slot_mask
    sp = gather_padded(s_flat, sd.pad_index, mask)
    lp = sd.labels2d
    zero = torch.zeros((), dtype=torch.float32, device=sp.device)
    # per-query recentering keeps exp() in range; the shift cancels inside
    # every u_i * v_j product, so S and pi are exact up to the clamp
    smax = torch.where(mask, sp, -3.0e38).amax(dim=1)
    smin = torch.where(mask, sp, 3.0e38).amin(dim=1)
    c = torch.where(sd.query_mask, 0.5 * (smax + smin), zero)
    d = torch.clamp(sp - c[:, None], -_SCORE_CLAMP, _SCORE_CLAMP)
    u = torch.where(mask, torch.exp(d), zero)
    v = torch.where(mask, torch.exp(-d), zero)
    row = torch.zeros_like(u)
    col = torch.zeros_like(u)
    for lev in levels:  # L is small: graded labels
        is_l = (lp == lev) & mask
        vl = torch.where(is_l, v, zero)
        ul = torch.where(is_l, u, zero)
        # exclusive suffix / prefix sums along the slot (dataset-order) axis:
        # the docs after i with this label / before i with it
        suf = torch.flip(_scan(torch.flip(vl, (1,)), 1), (1,)) - vl
        pre = _scan(ul, 1) - ul
        row = row + torch.where(lp < lev, suf, zero)
        col = col + torch.where(lp > lev, pre, zero)
    rowsum = u * row  # sum over j > i with l_j > l_i of exp(s_i - s_j)
    colsum = v * col  # sum over j < i with l_j < l_i of exp(s_j - s_i)
    per_q = query_sum(rowsum)
    S = torch.sum(sd.queries.gather(per_q) if group is not None else per_q)
    # no label-discordant pair anywhere: zero potentials (and alpha 0), as
    # the explicit D would give; an unguarded 0/0 would poison the model
    pi_p = torch.where(S > 0.0, (colsum - rowsum) / torch.clamp(S, min=1e-30), zero)
    pi = pi_p[sd.inv_q, sd.inv_slot] * sd.doc_mask.to(torch.float32)
    return pi, S


def potential_histogram(binned: torch.Tensor, pi: torch.Tensor, doc_mask: torch.Tensor,
                        num_bins: int, f_used: int = 0, group=None,
                        num_docs: int = 0) -> torch.Tensor:
    """``hist[f, b] = sum of pi over the docs in doc_mask with bin b in
    feature f``, float32 ``[F, B]`` over the first ``f_used`` columns (0 =
    all): K4 with the one channel ``pi`` on the card, under the scale of
    ``pi``'s max bits and ``num_docs`` real docs (0: every row), the
    scatter-add in dataset order on the CPU (JAX rankboost.py:121-125).
    Under ``group`` the histogram is every rank's docs': the card's int64
    sums (under the ranks' common scale) or the CPU's float sums are added
    over the ranks."""
    if binned.device.type == "cuda":
        values_t = pi[None, :].contiguous()
        return masked_histogram_t(binned, values_t, doc_mask, num_bins, f_used=f_used,
                                  group=group,
                                  scale=histogram_scale(values_t, group, num_docs))[:, :, 0]
    cols = binned[:, :f_used] if f_used else binned
    hist = masked_histogram_scatter(cols, pi[:, None], doc_mask, num_bins)[:, :, 0]
    return group.all_reduce_sum(hist) if group is not None else hist


def best_weak_ranker(hist: torch.Tensor):
    """``(flat index f * B + t, r)`` of the largest ``r(f, t) = sum of hist
    over bins > t``, on the device; ties go to the first index, as
    ``jnp.argmax`` breaks them.  Bins holding no doc leave r at the value of
    the bin before, so a pad bin never beats the real one it follows."""
    cum = _scan(hist, 1)
    r = (cum[:, -1:] - cum).reshape(-1)
    best = torch.argmax(r)
    return best, r[best]


def pair_potentials(s_flat: torch.Tensor, sd: StepData, levels: tuple, num_bins: int,
                    f_used: int = 0, group=None, num_docs: int = 0):
    """``(f_star, t_star, best_r, S, pi)``, all on the device: the potentials
    of the scores ``s_flat`` and the weak ranker that maximizes ``r``
    (JAX rankboost.py:71-131), over every rank's docs under ``group``."""
    pi, S = potentials(s_flat, sd, levels, group)
    hist = potential_histogram(sd.binned, pi, sd.doc_mask, num_bins, f_used, group,
                               num_docs)
    best, best_r = best_weak_ranker(hist)
    return best // num_bins, best % num_bins, best_r, S, pi


def _to_device(padded: PaddedDataset, device) -> PaddedDataset:
    return dataclasses.replace(padded, **{
        f.name: getattr(padded, f.name).to(device)
        for f in dataclasses.fields(padded)
        if isinstance(getattr(padded, f.name), torch.Tensor)})


class RankBoost(LTRAlgorithm):
    NAME = "RANKBOOST"

    def __init__(self, ntrees: int = 1000, nthresholds: int = 255, seed: int = 0):
        """``ntrees`` is the most weak rankers (the reference's num-trees)."""
        self.T = int(ntrees)
        self.nthresholds = int(nthresholds)
        self.seed = int(seed)
        self.features_: Optional[np.ndarray] = None  # [T] int32
        self.thetas_: Optional[np.ndarray] = None  # [T] float32
        self.signs_: Optional[np.ndarray] = None  # [T] int32
        self.alphas_: Optional[np.ndarray] = None  # [T] float32
        self.best_T: int = 0
        self.history: dict = {}

    def learn(self, train: Dataset, valid: Optional[Dataset] = None, metric=None,
              verbose: bool = True, device=None, mesh=None) -> dict:
        """Train on ``device`` (the CUDA card by default; "cpu" runs the plain
        versions), or with ``mesh``, a ``parallel.DataGroup``, on this rank's
        block of ``train`` on the group's device (every rank returns the
        same model).  Returns the history: train and valid metric per round,
        ``best_T`` and each round's wall seconds (``iter_seconds``, ended by
        the round's metric read)."""
        global HOST_SYNCS
        refuse_mesh(mesh, "RankBoost.learn(mesh=...)", one_d=ONE_D)
        metric = metric or self.default_metric()
        levels = [float(x) for x in np.unique(train.labels)]
        if len(levels) > _MAX_LABEL_LEVELS:
            raise ValueError(
                f"RANKBOOST: {len(levels)} distinct labels; the label-level "
                f"potential sums unroll per level (cap {_MAX_LABEL_LEVELS}). "
                "Quantize the labels first."
            )
        levels = tuple(levels)
        tr = TrainData.build(train, self.nthresholds, device=device, group=mesh)
        sd, group = tr.step, tr.group
        device = sd.binned.device
        verbose = verbose and (group is None or group.rank == 0)
        B = tr.num_bins
        f_used = tr.num_real_features
        if valid is not None:
            vpadded = _to_device(shard_and_pad(valid), device)
            vX = torch.from_numpy(np.ascontiguousarray(vpadded.features)).to(device)
            valid_scores = torch.zeros(vX.shape[0], dtype=torch.float64, device=device)

        scores = torch.zeros(tr.padded.num_docs_padded, dtype=torch.float32, device=device)
        features, thetas, alphas = [], [], []
        S_last = None
        z_t = 1.0
        max_alpha = 0.0
        best_va, best_T = -np.inf, 0
        hist_tr, hist_va = [], []
        iter_seconds = []
        if verbose:
            print(f"# {self.NAME}: T={self.T}")
        for t in range(self.T):
            t_iter = time.perf_counter()
            f_star, t_star, best_r, S, _ = pair_potentials(scores, sd, levels, B, f_used,
                                                           group, tr.num_docs)
            # one transfer: the weak ranker, best r and S (exact in float64)
            f_i, t_i, r_best, S = torch.stack(
                [f_star.double(), t_star.double(), best_r.double(), S.double()]).tolist()
            HOST_SYNCS += 1
            f_i, t_i = int(f_i), int(t_i)
            # z_t = S_t / S_{t-1}: the reference's running Z (the sum of the
            # updated D before renormalization, rankboost.cc:419-445)
            if S_last:  # S == 0 (no discordant pair) keeps z_t at 1
                z_t = S / S_last
            S_last = S
            theta = float(tr.thresholds[f_i, t_i])
            r_t = z_t * r_best
            if r_t >= 1:
                alpha = max_alpha * r_t
            else:
                alpha = float(np.log((z_t + r_t) / (z_t - r_t)) / 2.0)
                max_alpha = max(max_alpha, alpha)
            h = (bin_columns(sd.binned, f_i) > t_i).to(torch.float32) \
                * sd.doc_mask.to(torch.float32)
            scores = scores + np.float32(alpha) * h
            metrics = [eval_metric(metric, sd, scores, group)]
            if valid is not None:
                # the validation fold in float64 with the float64 alpha, as
                # the JAX package scores it on the host
                valid_scores += alpha * (vX[:, f_i] > theta).to(torch.float64)
                metrics.append(metric.evaluate_padded(vpadded, valid_scores.float()))
            metrics = torch.stack(metrics).tolist()
            HOST_SYNCS += 1
            iter_seconds.append(time.perf_counter() - t_iter)
            m_tr = metrics[0]
            features.append(f_i)
            thetas.append(theta)
            alphas.append(alpha)
            hist_tr.append(m_tr)
            improved = False
            if valid is not None:
                m_va = metrics[1]
                hist_va.append(m_va)
                if m_va > best_va:
                    best_va, best_T, improved = m_va, t + 1, True
            else:
                best_T = t + 1
            if verbose and (t < 5 or (t + 1) % 10 == 0 or improved):
                vtxt = f" {hist_va[-1]:.6f}" if valid is not None else ""
                print(f"# {t + 1:5d} f={f_i} theta={theta:.4g} alpha={alpha:.4g} "
                      f"{m_tr:.6f}{vtxt}{' *' if improved else ''}")

        self.best_T = best_T
        self.features_ = np.asarray(features[:best_T], np.int32)
        self.thetas_ = np.asarray(thetas[:best_T], np.float32)
        self.signs_ = np.ones(best_T, np.int32)
        self.alphas_ = np.asarray(alphas[:best_T], np.float32)
        self.history = {"train": hist_tr, "valid": hist_va, "best_T": best_T,
                        "iter_seconds": iter_seconds}
        #: the train fold's scores after the last round, flat padded order
        #: (this rank's block under a group)
        self.train_scores = scores
        return self.history

    # -- inference -----------------------------------------------------------

    def _require_model(self):
        if self.features_ is None:
            raise RuntimeError("RANKBOOST: no trained model")

    def scorer_path(self) -> str:
        return "rankboost"

    def device_scorer(self, ds: Dataset, device=None):
        """(fn, features on ``device``): ``fn`` maps the uploaded features to
        float64 scores ``[x[f_t] > theta_t] @ (alpha * sign)``.  On the CPU
        the JAX package's numpy expression (rankboost.py:303-307), bit for
        bit; on the card a gather, a compare and a float64 ``torch.matmul``
        in blocks of docs."""
        self._require_model()
        device = resolve_device(device)
        X = torch.from_numpy(np.ascontiguousarray(ds.features, np.float32))
        if device.type != "cuda":
            def fn(x):
                bits = (x.numpy()[:, self.features_] > self.thetas_[None, :]).astype(np.float32)
                return torch.from_numpy(bits @ (self.alphas_ * self.signs_))
            return fn, X.to(device)
        f = torch.from_numpy(self.features_.astype(np.int64)).to(device)
        th = torch.from_numpy(self.thetas_).to(device)
        w = torch.from_numpy(self.alphas_ * self.signs_).to(device)
        step = max(1, _SCORE_BLOCK_CELLS // max(1, len(self.features_)))

        def fn(x):
            return torch.cat([(x[i:i + step, f] > th).to(torch.float64) @ w
                              for i in range(0, x.shape[0], step)]) \
                if x.shape[0] else torch.zeros(0, dtype=torch.float64, device=x.device)
        return fn, X.to(device)

    def score_dataset(self, ds: Dataset, device=None) -> np.ndarray:
        fn, X = self.device_scorer(ds, device)
        return fn(X).cpu().numpy()

    def partial_scores_dataset(self, ds: Dataset, device=None) -> np.ndarray:
        """Per weak ranker ``sign * [x[f] > theta]``, float32 ``[docs, T]``
        (the --detailed file; Cleaver's input)."""
        self._require_model()
        device = resolve_device(device)
        X = torch.from_numpy(np.ascontiguousarray(ds.features, np.float32)).to(device)
        f = torch.from_numpy(self.features_.astype(np.int64)).to(device)
        th = torch.from_numpy(self.thetas_).to(device)
        sign = torch.from_numpy(self.signs_.astype(np.float32)).to(device)
        return ((X[:, f] > th).to(torch.float32) * sign).cpu().numpy()

    def get_weights(self) -> np.ndarray:
        return np.asarray(self.alphas_, np.float64)

    def update_weights(self, weights) -> None:
        """Overwrite the alphas (rankboost.cc:564-576; nothing is removed)."""
        w = np.asarray(weights, np.float32)
        if len(w) != self.best_T:
            raise ValueError("weight size mismatch")
        self.alphas_ = w

    # -- XML (rankboost.cc:540-562) -----------------------------------------

    def _to_xml(self):
        import xml.etree.ElementTree as ET

        root = ET.Element("ranker")
        info = ET.SubElement(root, "info")
        ET.SubElement(info, "type").text = self.NAME
        ET.SubElement(info, "maxweakrankers").text = str(self.T)
        ens = ET.SubElement(root, "ensemble")
        for t in range(self.best_T):
            wr = ET.SubElement(ens, "weakranker")
            ET.SubElement(wr, "id").text = str(t)
            ET.SubElement(wr, "featureid").text = str(int(self.features_[t]))
            ET.SubElement(wr, "theta").text = repr(float(self.thetas_[t]))
            ET.SubElement(wr, "sign").text = str(int(self.signs_[t]))
            ET.SubElement(wr, "alpha").text = repr(float(self.alphas_[t]))
        return root

    @classmethod
    def _from_xml(cls, root):
        algo = cls(ntrees=int(root.find("info/maxweakrankers").text))
        wrs = root.findall("ensemble/weakranker")
        algo.best_T = len(wrs)
        algo.features_ = np.asarray([int(w.find("featureid").text) for w in wrs], np.int32)
        algo.thetas_ = np.asarray([float(w.find("theta").text) for w in wrs], np.float32)
        algo.signs_ = np.asarray([int(w.find("sign").text) for w in wrs], np.int32)
        algo.alphas_ = np.asarray([float(w.find("alpha").text) for w in wrs], np.float32)
        return algo

