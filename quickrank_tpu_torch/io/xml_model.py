"""QuickRank-compatible XML model serialization (counterpart of
quickrank_tpu/io/xml_model.py; the same on-disk format, so a model saved by
either package loads in the other)::

  <ranker><info><type>LAMBDAMART</type>...</info>
    <ensemble><tree id="1" weight="0.1"><split>
      <feature>1-based fid</feature><threshold>...</threshold>
      <split pos="left">...</split><split pos="right">...</split>
    </split></tree>...</ensemble></ranker>

Leaf outputs and weights use Python's shortest repr of the double,
thresholds 9 significant digits, so float32 values round-trip exactly.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from quickrank_tpu_torch.trees.structs import EnsembleTensors

# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _fmt_f(x: float) -> str:
    # 9 significant digits (fractional=False): a fractional digit cap would
    # truncate small thresholds and break the float32 round trip
    return np.format_float_positional(
        np.float32(x), precision=9, unique=True, trim="0", fractional=False
    )


def _fmt_d(x: float) -> str:
    return repr(float(x))


def _append_split(parent: ET.Element, host: dict, t: int, node: int,
                  pos: Optional[str]):
    split = ET.SubElement(parent, "split")
    if pos:
        split.set("pos", pos)
    if host["is_leaf"][t, node]:
        ET.SubElement(split, "output").text = _fmt_d(host["leaf_value"][t, node])
    else:
        # 1-based feature ids on disk
        ET.SubElement(split, "feature").text = str(int(host["feature"][t, node]) + 1)
        ET.SubElement(split, "threshold").text = _fmt_f(host["threshold"][t, node])
        _append_split(split, host, t, int(host["left"][t, node]), "left")
        _append_split(split, host, t, int(host["right"][t, node]), "right")


def ensemble_to_xml(ens: EnsembleTensors, info: dict, type_name: str) -> ET.Element:
    ranker = ET.Element("ranker")
    info_el = ET.SubElement(ranker, "info")
    ET.SubElement(info_el, "type").text = type_name
    for key, val in info.items():
        ET.SubElement(info_el, key).text = str(val)
    host = ens.numpy()
    ens_el = ET.SubElement(ranker, "ensemble")
    for t in range(ens.num_trees):
        tree_el = ET.SubElement(ens_el, "tree")
        tree_el.set("id", str(t + 1))
        tree_el.set("weight", _fmt_d(host["weight"][t]))
        _append_split(tree_el, host, t, 0, None)
    return ranker


def save_model(algo, path: str) -> None:
    """Serialize a model (LTR_Algorithm::save)."""
    root = algo._to_xml()
    tree = ET.ElementTree(root)
    ET.indent(tree, space="\t")
    with open(path, "wb") as f:
        f.write(b'<?xml version="1.0"?>\n')
        tree.write(f)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


class _ParsedNode:
    __slots__ = ("feature", "threshold", "left", "right", "output")

    def __init__(self):
        self.feature = -1
        self.threshold = 0.0
        self.left = None
        self.right = None
        self.output = 0.0

    @property
    def is_leaf(self):
        return self.left is None


def _parse_split(el: ET.Element) -> _ParsedNode:
    n = _ParsedNode()
    for child in el:
        if child.tag == "output":
            n.output = float(child.text)
            return n
        if child.tag == "feature":
            n.feature = int(child.text) - 1  # back to 0-based
        elif child.tag == "threshold":
            n.threshold = float(child.text)
        elif child.tag == "split":
            if child.get("pos") == "left":
                n.left = _parse_split(child)
            else:
                n.right = _parse_split(child)
    return n


def _count_nodes(n: _ParsedNode) -> tuple[int, int]:
    """(num_nodes, max_depth)."""
    if n.is_leaf:
        return 1, 0
    ln, ld = _count_nodes(n.left)
    rn, rd = _count_nodes(n.right)
    return 1 + ln + rn, 1 + max(ld, rd)


def parse_ensemble(ranker: ET.Element) -> tuple[EnsembleTensors, int]:
    """<ensemble> -> dense EnsembleTensors (+ max tree depth).  Nodes are
    numbered in pre-order, as the JAX package numbers them."""
    trees = []
    weights = []
    for tree_el in ranker.find("ensemble"):
        weights.append(float(tree_el.get("weight", "1.0")))
        trees.append(_parse_split(tree_el.find("split")))
    T = len(trees)
    counts = [_count_nodes(t) for t in trees]
    max_nodes = max(c[0] for c in counts) if counts else 1
    max_depth = max(c[1] for c in counts) if counts else 0

    feature = np.full((T, max_nodes), -1, np.int32)
    threshold = np.zeros((T, max_nodes), np.float32)
    left = np.zeros((T, max_nodes), np.int32)
    right = np.zeros((T, max_nodes), np.int32)
    is_leaf = np.ones((T, max_nodes), bool)
    leaf_value = np.zeros((T, max_nodes), np.float32)

    for t, root in enumerate(trees):
        counter = [0]

        def assign(n: _ParsedNode) -> int:
            i = counter[0]
            counter[0] += 1
            if n.is_leaf:
                leaf_value[t, i] = n.output
            else:
                feature[t, i] = n.feature
                threshold[t, i] = n.threshold
                is_leaf[t, i] = False
                left[t, i] = assign(n.left)
                right[t, i] = assign(n.right)
            return i

        assign(root)

    ens = EnsembleTensors.from_numpy(dict(
        feature=feature, threshold=threshold,
        threshold_bin=np.full((T, max_nodes), -1, np.int32),
        left=left, right=right, is_leaf=is_leaf, leaf_value=leaf_value,
        weight=np.asarray(weights, np.float32), num_trees=T,
    ))
    return ens, max_depth


def _registry():
    from quickrank_tpu_torch.learning.custom import CustomLTR
    from quickrank_tpu_torch.learning.dart import Dart
    from quickrank_tpu_torch.learning.lambdamart import LambdaMart
    from quickrank_tpu_torch.learning.linear import CoordinateAscent, LineSearch
    from quickrank_tpu_torch.learning.mart import Mart
    from quickrank_tpu_torch.learning.meta import MetaCleaver
    from quickrank_tpu_torch.learning.obliviousmart import (
        ObliviousLambdaMart,
        ObliviousMart,
    )
    from quickrank_tpu_torch.learning.randomforest import RandomForest
    from quickrank_tpu_torch.learning.rankboost import RankBoost
    from quickrank_tpu_torch.learning.selective import LambdaMartSelective
    from quickrank_tpu_torch.learning.stochasticnegative import StochasticNegative

    return {"MART": Mart, "LAMBDAMART": LambdaMart, "OBVMART": ObliviousMart,
            "OBVLAMBDAMART": ObliviousLambdaMart, "DART": Dart,
            "RANDOMFOREST": RandomForest, "LAMBDAMART-SELECTIVE": LambdaMartSelective,
            "STOCHASTIC-NEGATIVE": StochasticNegative, "COORDASC": CoordinateAscent,
            "LINESEARCH": LineSearch, "RANKBOOST": RankBoost, "CUSTOM": CustomLTR,
            "METACLEAVER": MetaCleaver}


def load_element(root: ET.Element):
    """The model of a ``<ranker>`` element, dispatched on its type
    (ltr_algorithm.cc:85-128)."""
    type_name = root.find("info/type").text.strip()
    reg = _registry()
    if type_name not in reg:
        raise ValueError(f"unknown ranker type {type_name!r}; known: {sorted(reg)}")
    return reg[type_name]._from_xml(root)


def load_model(path: str):
    """Type-dispatched load of a model file."""
    return load_element(ET.parse(path).getroot())
