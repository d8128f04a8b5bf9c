"""AOT scorer export: one file that serves a model without this package
(counterpart of quickrank_tpu/io/export.py, whose ``--generator stablehlo``
artifact is written by ``jax.export``).

The reference ships rankers to production by generating C source from a
model (src/io/generate_*.cc; ``io/codegen.py``).  This module writes the
batched scorer instead, the model's constants embedded, as a
``torch.export`` archive (``--generator pt2``).  A serving process loads and
calls it with only torch installed: no quickrank_tpu_torch, no XML model,
no retracing.  The batch dimension is symbolic by default, so one archive
serves any batch size.

The exported computation is the plain one, as in the JAX package: the
QuickScorer scan over the trees (bitwise ``trees/qs.py::score_qs``, the
Kahan chain over every slot of the table, dead ones included), the linear
dot product (``ops/scoring.py::matvec_f32``, bitwise XLA's ``X @ w`` on the
CPU) or RankBoost's weighted threshold bits through the same product.  The
CUDA kernels are runtime specializations and are not exported: the archive
must load where this package and its build are absent.

The tree scorer is one ``torch._higher_order_ops.scan`` over the trees
(JAX scans over groups of trees): its graph does not grow with the
ensemble.  ``scan`` is a private torch API.  Nothing in the graph may
depend on the batch size, or the symbolic batch is lost, so the scan takes
whole trees and never chunks the documents as ``score_qs`` does.
"""

from __future__ import annotations

import io
from typing import Callable, Optional

import numpy as np
import torch
from torch._higher_order_ops import scan

from quickrank_tpu_torch.learning.base import resolve_device
from quickrank_tpu_torch.ops.scoring import kahan_add, matvec_f32
from quickrank_tpu_torch.trees.qs import ensemble_to_qs, unpack_leaf_masks

GENERATOR_NAME = "pt2"


def _is_linear(model) -> bool:
    """Linear rankers (CA/LS) score by dot product; tree models also expose
    get_weights (per-tree weights), so dispatch on the linear base class,
    not on the method."""
    from quickrank_tpu_torch.learning.linear import _LinearRanker

    return isinstance(model, _LinearRanker)


def _is_rankboost(model) -> bool:
    from quickrank_tpu_torch.learning.rankboost import RankBoost

    return isinstance(model, RankBoost)


def _unwrap(model):
    """MetaCleaver delegates scoring to its inner ranker: export that."""
    from quickrank_tpu_torch.learning.meta import MetaCleaver

    return model.ltr_algo if isinstance(model, MetaCleaver) else model


def _model_num_features(model) -> int:
    """Smallest feature-vector width the model can score (max used global
    feature id + 1)."""
    if _is_linear(model):
        return int(np.asarray(model.get_weights()).shape[0])
    if _is_rankboost(model):
        if model.features_ is None:
            raise RuntimeError("RANKBOOST: no trained model to export")
        return int(np.asarray(model.features_).max()) + 1
    ens = model._require_model()
    h = ens.numpy()
    T = int(ens.num_trees)
    used = h["feature"][:T][~h["is_leaf"][:T]]
    return int(used.max()) + 1 if used.size else 1


class LinearScorer(torch.nn.Module):
    """``X @ w`` in float32, associated as XLA on the CPU evaluates it."""

    def __init__(self, w: np.ndarray):
        super().__init__()
        self.register_buffer("w", torch.tensor(w, dtype=torch.float32))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return matvec_f32(X, self.w)


class RankBoostScorer(torch.nn.Module):
    """``[x[f_t] > theta_t] @ (alpha_t * sign_t)`` in float32."""

    def __init__(self, fid: np.ndarray, theta: np.ndarray, aw: np.ndarray):
        super().__init__()
        self.register_buffer("fid", torch.tensor(fid, dtype=torch.int64))
        self.register_buffer("theta", torch.tensor(theta, dtype=torch.float32))
        self.register_buffer("aw", torch.tensor(aw, dtype=torch.float32))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        bits = (X[:, self.fid] > self.theta).float()
        return matvec_f32(bits, self.aw)


class QSScorer(torch.nn.Module):
    """The QuickScorer scan over the slots of a ``trees/qs.py::QSEnsemble``.

    A step takes one tree: the false bits by a gather and a compare, the
    exclusion counts by a product of {0, 1} matrices (exact integers in
    float32, also under TF32), the leftmost leaf no false node excludes,
    its value, and the Kahan step; bitwise ``score_qs``."""

    def __init__(self, qs):
        super().__init__()
        self.register_buffer("fid", qs.fid.long())
        self.register_buffer("thr", qs.thr)
        # bool [T, I, L]: a byte a node and leaf in the archive
        self.register_buffer("excl", unpack_leaf_masks(qs))
        self.register_buffer("leafval", qs.leafval)
        self.register_buffer("weight", qs.weight)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        def step(carry, tree):
            s, c = carry
            fid, thr, excl, leafval, w = tree
            false_bits = (X[:, fid] > thr).float()
            exit_leaf = ((false_bits @ excl.float()) == 0).to(torch.uint8).argmax(dim=1)
            s, c = kahan_add(s, c, w, leafval[exit_leaf])
            return (s, c), s.new_zeros(())  # scan wants a per-step output

        zero = X.new_zeros(X.shape[0])
        (s, _), _ = scan(step, (zero, zero.clone()),
                         (self.fid, self.thr, self.excl, self.leafval, self.weight))
        return s


def _scorer_module(model) -> torch.nn.Module:
    if _is_linear(model):
        return LinearScorer(model.get_weights())
    if _is_rankboost(model):
        # float32 as the JAX package exports them (not score_dataset's float64)
        aw = np.asarray(model.alphas_ * model.signs_, np.float32)
        return RankBoostScorer(model.features_, model.thetas_, aw)
    return QSScorer(ensemble_to_qs(model._require_model()))


def export_scorer(model, path: Optional[str] = None, num_features: Optional[int] = None,
                  batch: Optional[int] = None) -> bytes:
    """Serialize the model's batched scorer as a ``torch.export`` archive.

    num_features: feature-matrix width baked into the archive (defaults to
        the model's max used feature id + 1; score calls must pass exactly
        this width, so slice wider datasets).
    batch: fix the leading dim; None exports a symbolic batch dimension.
    The program is traced on the CPU and its constants are CPU tensors, so
    the archive loads on any machine (:func:`load_scorer` moves it).
    Returns the archive's bytes (also written to ``path`` if given)."""
    from torch.export import Dim

    model = _unwrap(model)
    F_min = _model_num_features(model)  # also raises on untrained models
    F = int(num_features) if num_features else F_min
    if F < F_min:
        # an out-of-bounds gather in the archive would fail only at call time
        # on the CPU and read garbage or fault on the card; fail loudly now
        raise ValueError(
            f"num_features={F} is narrower than the model's max used "
            f"feature id ({F_min - 1}); scores would be silently wrong"
        )
    module = _scorer_module(model).eval()
    example = torch.zeros((2 if batch is None else int(batch), F), dtype=torch.float32)
    shapes = ({0: Dim("b", min=0)},) if batch is None else None
    program = torch.export.export(module, (example,), dynamic_shapes=shapes)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_scorer(src, device=None) -> Callable[[np.ndarray], np.ndarray]:
    """Load an exported scorer (path or bytes) onto ``device`` (``None`` =
    the CUDA card, an error without one) as an ``X -> float32 scores``
    callable; X is a numpy array or a tensor of the archive's width.  Needs
    only torch: the model's constants live in the archive."""
    from torch.export.passes import move_to_device_pass

    device = resolve_device(device)
    if isinstance(src, (bytes, bytearray)):
        src = io.BytesIO(bytes(src))
    fn = move_to_device_pass(torch.export.load(src), device).module()

    def call(X) -> np.ndarray:
        X = torch.as_tensor(X, dtype=torch.float32).to(device)
        with torch.no_grad():
            return fn(X).cpu().numpy()

    return call
