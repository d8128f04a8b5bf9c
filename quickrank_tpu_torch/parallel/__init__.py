"""Query-sharded data-parallel training over torch.distributed (counterpart
of quickrank_tpu/parallel): ``mesh.py`` (the rank's ``DataGroup``, its
collectives, ``make_mesh``, ``init_distributed``, the 2-D data x feature
mesh's ``make_mesh_2d`` and ``Mesh2D``, sharded scoring),
``multihost.py`` (per-process data loading) and ``launch.py`` (ranks on one
host)."""

from quickrank_tpu_torch.parallel.mesh import (
    DataGroup,
    Mesh2D,
    RowShards,
    init_distributed,
    init_distributed_2d,
    make_mesh,
    make_mesh_2d,
    score_rows_sharded,
)

__all__ = ["DataGroup", "Mesh2D", "RowShards", "init_distributed", "init_distributed_2d",
           "make_mesh", "make_mesh_2d", "score_rows_sharded"]
