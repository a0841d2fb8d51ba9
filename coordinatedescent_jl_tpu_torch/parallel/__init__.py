"""Multi-device tiers on ``torch.distributed`` (counterpart of
``coordinatedescent_jl_tpu/parallel``): the feature-sharded engine and its
drivers (``sharded_cd.py``), the sharded group engine
(``sharded_group.py``), the observation- and tile-sharded tiers
(``row_sharded.py``), the sharded scenario batches (``batch.py``), process
groups, meshes and sharded ingestion (``distributed.py``), and the
multi-rank dry run (``dryrun.py``).  Every entry point is SPMD: each rank
of the mesh calls it with the same arguments and gets the replicated
result.
"""

from .sharded_cd import (
    coordinate_descent_sharded,
    symmetric_coordinate_descent_sharded,
    lasso_sharded,
    sqrt_lasso_sharded,
    scaled_lasso_sharded,
    feasible_lasso_sharded,
    lasso_path_sharded,
    solve_blocked_sharded,
)
from .sharded_group import (
    group_coordinate_descent_sharded,
    group_lasso_sharded,
)
from .row_sharded import (
    coordinate_descent_row_sharded,
    lasso_path_row_sharded,
    lasso_row_sharded,
    lasso_tile_sharded,
    sqrt_lasso_row_sharded,
)
from .batch import (
    lasso_lambda_batch,
    lasso_grid_sharded,
    locpoly_batch,
    lvocv_locpoly_batch,
    lvocv_locpolyl1_batch,
)
from .distributed import (
    initialize_distributed,
    feature_mesh,
    grid_mesh,
    plan_column_shards,
    plan_device_columns,
    load_design_shard,
    shard_design_matrix,
)

__all__ = [
    "coordinate_descent_sharded",
    "symmetric_coordinate_descent_sharded",
    "lasso_sharded",
    "sqrt_lasso_sharded",
    "scaled_lasso_sharded",
    "feasible_lasso_sharded",
    "lasso_path_sharded",
    "solve_blocked_sharded",
    "group_coordinate_descent_sharded",
    "group_lasso_sharded",
    "coordinate_descent_row_sharded",
    "lasso_path_row_sharded",
    "lasso_row_sharded",
    "lasso_tile_sharded",
    "sqrt_lasso_row_sharded",
    "lasso_lambda_batch",
    "lasso_grid_sharded",
    "locpoly_batch",
    "lvocv_locpoly_batch",
    "lvocv_locpolyl1_batch",
    "initialize_distributed",
    "feature_mesh",
    "grid_mesh",
    "plan_column_shards",
    "plan_device_columns",
    "load_design_shard",
    "shard_design_matrix",
]
