"""Optimization factory (counterpart of quickrank_tpu/optimization/
factory.py, after src/optimization/optimization_factory.cc and
cleaver_factory.cc): builds Cleaver, with an embedded LineSearch when
``with_line_search`` or a line-search model is given."""

from __future__ import annotations

from typing import Optional

from quickrank_tpu_torch.learning.linear import LineSearch
from quickrank_tpu_torch.optimization.cleaver import Cleaver


def optimization_factory(opt_algo: str = "EPRUNING", opt_method: str = "QUALITY_LOSS",
                         pruning_rate: float = 0.5, with_line_search: bool = False,
                         line_search: Optional[LineSearch] = None,
                         line_search_kwargs: Optional[dict] = None, seed: int = 0) -> Cleaver:
    name = opt_algo.upper()
    if name not in ("EPRUNING", "CLEAVER"):
        raise ValueError(f"unknown optimization algorithm {opt_algo!r}")
    ls = line_search
    if ls is None and with_line_search:
        ls = LineSearch(**(line_search_kwargs or {}))
    return Cleaver(pruning_method=opt_method, pruning_rate=pruning_rate, line_search=ls,
                   seed=seed)
