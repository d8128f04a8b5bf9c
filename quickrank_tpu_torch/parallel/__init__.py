"""Query-sharded data-parallel training over torch.distributed (counterpart
of quickrank_tpu/parallel): ``mesh.py`` (the rank's ``DataGroup``, its
collectives, ``make_mesh``, ``init_distributed``, sharded scoring),
``multihost.py`` (per-process data loading) and ``launch.py`` (ranks on one
host)."""

from quickrank_tpu_torch.parallel.mesh import (
    DataGroup,
    RowShards,
    init_distributed,
    make_mesh,
    score_rows_sharded,
)

__all__ = ["DataGroup", "RowShards", "init_distributed", "make_mesh",
           "score_rows_sharded"]
