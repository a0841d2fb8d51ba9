from .options import CDOptions, IterLassoOptions
from . import helpers
from .checkpoint import (
    PathCheckpoint,
    save_checkpoint,
    load_checkpoint,
    lasso_path_resumable,
    ShardedPathCheckpoint,
    save_sharded_checkpoint,
    load_sharded_checkpoint,
    lasso_path_resumable_sharded,
)
from .profiling import (
    EpochTrace,
    RooflineReport,
    SigmaRoundTrace,
    simple_timeit,
    solve_with_trace,
    scaled_lasso_with_trace,
    group_solve_with_trace,
    pass_roofline,
    pass_roofline_multi,
    solve_x_traffic,
    XTrafficReport,
    debug_nans,
    lasso_sharded_with_trace,
    measured_peak_hbm,
    trace,
)
