from .options import CDOptions, IterLassoOptions
from . import helpers
from .checkpoint import (
    PathCheckpoint,
    save_checkpoint,
    load_checkpoint,
    lasso_path_resumable,
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
    measured_peak_hbm,
    trace,
)
