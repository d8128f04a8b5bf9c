"""Synthetic ensembles for benchmarks and checks (counterpart of
quickrank_tpu/trees/random_ensemble.py: the same numpy draws, so one seed
gives an identical ensemble in both packages).  Scoring cost does not depend
on learned values, so these stand in for trained models of the same shape.
"""

from __future__ import annotations

import numpy as np

from quickrank_tpu_torch.trees.oblivious import ObliviousEnsemble
from quickrank_tpu_torch.trees.structs import EnsembleTensors


def random_balanced_ensemble(
    num_trees: int,
    depth: int,
    num_features: int,
    seed: int = 0,
    weight: float = 0.1,
) -> EnsembleTensors:
    """Complete binary trees of the given depth (2^depth leaves each)."""
    rng = np.random.default_rng(seed)
    n_internal = 2**depth - 1
    max_nodes = 2 ** (depth + 1) - 1
    T = num_trees

    feature = np.full((T, max_nodes), -1, np.int32)
    threshold = np.zeros((T, max_nodes), np.float32)
    left = np.zeros((T, max_nodes), np.int32)
    right = np.zeros((T, max_nodes), np.int32)
    is_leaf = np.ones((T, max_nodes), bool)
    leaf_value = np.zeros((T, max_nodes), np.float32)

    idx = np.arange(n_internal)
    feature[:, :n_internal] = rng.integers(0, num_features, size=(T, n_internal))
    threshold[:, :n_internal] = rng.normal(size=(T, n_internal)).astype(np.float32)
    left[:, :n_internal] = 2 * idx + 1
    right[:, :n_internal] = 2 * idx + 2
    is_leaf[:, :n_internal] = False
    leaf_value[:, n_internal:] = rng.normal(
        size=(T, max_nodes - n_internal)
    ).astype(np.float32)

    return EnsembleTensors.from_numpy(dict(
        feature=feature, threshold=threshold,
        threshold_bin=np.zeros((T, max_nodes), np.int32),
        left=left, right=right, is_leaf=is_leaf, leaf_value=leaf_value,
        weight=np.full((T,), weight, np.float32), num_trees=T,
    ))


def random_bestfirst_ensemble(num_trees, nleaves, num_features, seed=0):
    """Best-first-shaped trees: start from a root leaf, repeatedly split a
    random existing leaf (biased toward recent leaves so chains get deep,
    like deviance-guided growth on real data).  max_nodes = 2*nleaves-1."""
    rng = np.random.default_rng(seed)
    T = num_trees
    max_nodes = 2 * nleaves - 1
    feature = np.full((T, max_nodes), -1, np.int32)
    threshold = np.zeros((T, max_nodes), np.float32)
    left = np.zeros((T, max_nodes), np.int32)
    right = np.zeros((T, max_nodes), np.int32)
    is_leaf = np.ones((T, max_nodes), bool)
    leaf_value = np.zeros((T, max_nodes), np.float32)
    for t in range(T):
        leaves = [0]
        nxt = 1
        while nxt < max_nodes:
            # bias toward the newest leaf -> deep chains
            i = leaves.pop(-1 if rng.random() < 0.6 else rng.integers(len(leaves)))
            feature[t, i] = rng.integers(num_features)
            threshold[t, i] = rng.normal()
            left[t, i], right[t, i] = nxt, nxt + 1
            is_leaf[t, i] = False
            leaves += [nxt, nxt + 1]
            nxt += 2
        leaf_value[t, leaves] = rng.normal(size=len(leaves))
    return EnsembleTensors.from_numpy(dict(
        feature=feature, threshold=threshold,
        threshold_bin=np.zeros((T, max_nodes), np.int32),
        left=left, right=right, is_leaf=is_leaf, leaf_value=leaf_value,
        weight=np.full((T,), 0.1, np.float32), num_trees=T,
    ))


def random_oblivious_ensemble(num_trees: int, depth: int, num_features: int,
                              seed: int = 0, num_docs: int = 1 << 17):
    """(features f32 [num_docs, num_features], ObliviousEnsemble): the
    scoring workload of the JAX package's ``bench.py`` (bench.py:74-86),
    drawn as it draws it: one ``default_rng(seed)`` gives the normal
    features first, then the split features, thresholds and leaf values;
    every tree weighs 0.1.  Features and model come from one generator, so
    they are returned together."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(num_docs, num_features)).astype(np.float32)
    ens = ObliviousEnsemble.from_numpy(dict(
        fid=rng.integers(0, num_features, size=(num_trees, depth)).astype(np.int32),
        thr=rng.normal(size=(num_trees, depth)).astype(np.float32),
        thr_bin=np.zeros((num_trees, depth), np.int32),
        leaf=rng.normal(size=(num_trees, 2 ** depth)).astype(np.float32),
        weight=np.full((num_trees,), 0.1, np.float32),
        num_trees=num_trees,
    ))
    return feats, ens
