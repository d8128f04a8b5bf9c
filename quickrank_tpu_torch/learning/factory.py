"""LtR algorithm factory (counterpart of quickrank_tpu/learning/factory.py,
after src/learning/ltr_algorithm_factory.cc:41-262): construction by name
from a flat parameter dict, model-in loading, the restart-train state
import and the meta wrapping (``meta_factory``).

Every learner of the JAX package is ported: MART, LAMBDAMART, OBVMART,
OBVLAMBDAMART, DART, RANDOMFOREST, RANKBOOST, LAMBDAMART-SELECTIVE,
STOCHASTIC-NEGATIVE, COORDASC, LINESEARCH and CUSTOM, and METACLEAVER as a
meta algorithm.
"""

from __future__ import annotations

from typing import Optional

from quickrank_tpu_torch.learning.base import LTRAlgorithm

def _tree_kwargs(p: dict) -> dict:
    return dict(
        ntrees=p.get("num_trees", 1000),
        shrinkage=p.get("shrinkage", 0.1),
        nthresholds=p.get("num_thresholds", 255),
        nleaves=p.get("num_leaves", 10),
        minleafsupport=p.get("min_leaf_support", 1),
        esr=p.get("end_after_rounds", 100),
        subsample=p.get("subsample", 1.0),
        max_features=p.get("max_features", 1.0),
        seed=p.get("seed", 0),
        collapse_leaves_factor=p.get("collapse_leaves_factor", 0.0),
        max_depth=p.get("max_depth", 0),
        growth=p.get("growth", "best"),
        split_pack=p.get("split_pack", 4),
    )


def _linear_kwargs(p: dict) -> dict:
    return dict(
        num_points=p.get("num_samples", 21),
        window_size=p.get("window_size", 10.0),
        reduction_factor=p.get("reduction_factor", 0.95),
        max_iterations=p.get("max_iterations", 100),
        max_failed_vali=p.get("max_failed_valid", 20),
    )


def ltr_algorithm_factory(algo: str = "LAMBDAMART", model_in: Optional[str] = None,
                          restart_train: bool = False, **params) -> LTRAlgorithm:
    """Build (or load) an algorithm by its CLI name.

    ``model_in`` without ``restart_train`` loads the model for scoring; with
    ``restart_train`` the loaded ensemble seeds a fresh learner that continues
    training (``import_model_state``, mart.cc:493-517)."""
    if model_in is not None and not restart_train:
        return LTRAlgorithm.load(model_in)

    from quickrank_tpu_torch.learning.custom import CustomLTR
    from quickrank_tpu_torch.learning.dart import Dart
    from quickrank_tpu_torch.learning.lambdamart import LambdaMart
    from quickrank_tpu_torch.learning.linear import CoordinateAscent, LineSearch
    from quickrank_tpu_torch.learning.mart import Mart
    from quickrank_tpu_torch.learning.obliviousmart import (
        ObliviousLambdaMart,
        ObliviousMart,
    )
    from quickrank_tpu_torch.learning.randomforest import RandomForest
    from quickrank_tpu_torch.learning.rankboost import RankBoost
    from quickrank_tpu_torch.learning.selective import LambdaMartSelective
    from quickrank_tpu_torch.learning.stochasticnegative import StochasticNegative

    name = algo.upper().strip()
    tk = _tree_kwargs(params)
    if name == "MART":
        out = Mart(**tk)
    elif name == "LAMBDAMART":
        out = LambdaMart(**tk)
    elif name in ("OBVMART", "OBVLAMBDAMART"):
        tk.pop("nleaves")
        cls = ObliviousMart if name == "OBVMART" else ObliviousLambdaMart
        out = cls(treedepth=params.get("tree_depth", 3), **tk)
    elif name == "DART":
        p = params
        out = Dart(
            sample_type=p.get("sample_type", "UNIFORM"),
            normalize_type=p.get("normalize_type", "TREE"),
            adaptive_type=p.get("adaptive_type", "FIXED"),
            rate_drop=p.get("rate_drop", 0.1),
            skip_drop=p.get("skip_drop", 0.0),
            keep_drop=p.get("keep_drop", False),
            best_on_train=p.get("best_on_train", False),
            random_keep=p.get("random_keep", 0.0),
            drop_on_best=p.get("drop_on_best", False),
            **tk,
        )
    elif name == "RANDOMFOREST":
        out = RandomForest(**tk)
    elif name == "RANKBOOST":
        out = RankBoost(ntrees=tk["ntrees"], nthresholds=tk["nthresholds"], seed=tk["seed"])
    elif name == "LAMBDAMART-SELECTIVE":
        p = params
        out = LambdaMartSelective(
            sampling_iterations=p.get("sampling_iterations", 1),
            rank_sampling_factor=p.get("rank_sampling_factor", 1.0),
            random_sampling_factor=p.get("random_sampling_factor", 0.0),
            normalization_factor=p.get("normalization_factor", 100),
            adaptive_strategy=p.get("adaptive_strategy", "NO"),
            negative_strategy=p.get("negative_strategy", "RATIO"),
            **tk,
        )
    elif name == "STOCHASTIC-NEGATIVE":
        out = StochasticNegative(**tk)
    elif name == "COORDASC":
        out = CoordinateAscent(**_linear_kwargs(params))
    elif name == "LINESEARCH":
        out = LineSearch(adaptive=params.get("adaptive", False),
                         train_only_last=params.get("train_only_last", 0),
                         **_linear_kwargs(params))
    elif name == "CUSTOM":
        out = CustomLTR()
    else:
        raise ValueError(f"unknown LtR algorithm {algo!r}")

    if restart_train and model_in is not None:
        # the target algorithm checks type and hyperparameters itself, on the
        # host, before any device work
        out.import_model_state(LTRAlgorithm.load(model_in))
    return out


def meta_factory(meta_algo: str, ltr_algo, cleaver, **params):
    """Meta-algorithm wrapping (ltr_algorithm_factory.cc, meta section)."""
    from quickrank_tpu_torch.learning.meta import MetaCleaver

    if meta_algo.upper() != "METACLEAVER":
        raise ValueError(f"unknown meta algorithm {meta_algo!r}")
    return MetaCleaver(
        ltr_algo,
        cleaver,
        final_ntrees=params.get("final_num_trees", 1000),
        ntrees_per_iter=params.get("num_trees", 100),
        pruning_rate_per_iter=params.get("pruning_rate", 0.5),
        opt_last_only=params.get("opt_last_only", True),
        meta_esr=params.get("meta_end_after_rounds", 0),
        meta_verbose=params.get("meta_verbose", False),
    )
