"""coordinatedescent_jl_tpu_torch: the PyTorch + CUDA port of
``coordinatedescent_jl_tpu`` for one NVIDIA H100.

The vector-iterate estimators — ``lasso``, ``lasso_path`` (scan and
batched executions), ``refit_lasso_path``, ``sqrt_lasso``,
``scaled_lasso``, ``feasible_lasso``, ``coordinate_descent`` with the
least-squares, weighted, sqrt and quadratic losses — the group iterate
(``group_lasso``, ``group_coordinate_descent``, ``ProxL1Group`` through
``coordinate_descent``), the symmetric iterate
(``symmetric_coordinate_descent`` and the ``sym_*`` packing), and the
float64 polishes with their compensated certificates run in PyTorch, with
every TPU kernel of the JAX package (the fused active pass in its ls, wls
and sqrt forms, the restricted and the dense gradient sweeps, the two
phases of the fused KKT check) rewritten by hand for Hopper in CUDA C++
(``kernels/``, ``csrc/``); the group engine's full sweeps run on the
dense sweep kernel.  The varying-coefficient suite (``locpoly``,
``locpolyl1`` in its scan and batched executions, the LOO-CV and split
bandwidth scores, the interpolation utilities and the sandwich standard
errors) runs the wls kind of the block engine, so its scan drives K1's
wls form, K3/K4 and K5.  Profiling (``utils/profiling.py``: timing,
per-epoch and per-σ-round traces, the X-traffic report, K1's roofline
against the card's measured peak, NaN debugging) and checkpointing
(``utils/checkpoint.py``: the resumable λ path, whose resume is bit for
bit the uninterrupted run) are ported with their sharded halves
(``lasso_sharded_with_trace``, ``lasso_path_resumable_sharded``).  The
multi-device tiers (``parallel/``: the feature-sharded engine with its
path, scaled, feasible, group and symmetric drivers, the row and tile
tiers, the scenario batches, meshes and sharded ingestion) run on
``torch.distributed``, every rank of a mesh calling an entry point with
the same arguments.  The entry points run on the GPU unless the caller
passes ``device="cpu"`` (a sharded entry point on ``cuda:<LOCAL_RANK>``).  The
kernels are built with ``nvcc`` at first use on the machine with the GPU;
importing the package needs no GPU, no ``nvcc`` and no JAX.
"""

from .utils.options import CDOptions, IterLassoOptions
from .utils.helpers import (find_init_residuals, find_init_sigma,
                            find_largest_correlations, get_loadings,
                            get_sigma, sample_std, std_X)
from .ops.prox import (ProxL1, ProxL1Group, ProxZero, group_soft_threshold,
                       soft_threshold)
from .ops.losses import (LeastSquaresLoss, QuadraticLoss, SqrtLassoLoss,
                         WeightedLSLoss, gradient, num_coordinates, value)
from .ops.block_cd import coordinate_descent
from .ops.group_cd import group_coordinate_descent, group_lasso
from .ops.symmetric import (sym_indices, sym_num_coordinates, sym_pack,
                            sym_unpack, symmetric_coordinate_descent)
from .ops.compensated import (group_lasso_kkt_compensated,
                              lasso_duality_gap_compensated, loadings_f64,
                              sqrt_lasso_kkt_compensated)
from .ops.diagnostics import (lasso_duality_gap, lasso_duality_gap_f64,
                              lasso_kkt_residual)
from .models.lasso import (LassoSolution, feasible_lasso, lasso,
                           scaled_lasso, sqrt_lasso)
from .models.lasso_path import LassoPath, lasso_path, refit_lasso_path
from .models.varying_coefficient import (
    EpanechnikovKernel, GaussianKernel, SmoothingKernel, create_kernel,
    evaluate, expand_X, expand_wX, expand_Xt_w_X, expand_Xt_w_Y, get_beta,
    get_nonzero_coordinates, get_residuals, get_standard_error,
    get_standard_error_hew, locpoly, locpolyl1, lvocv_locpoly,
    lvocv_locpolyl1, refit_locpolyl1, sparse_coefficients, split_locpoly)
from .utils.checkpoint import (PathCheckpoint, ShardedPathCheckpoint,
                               lasso_path_resumable,
                               lasso_path_resumable_sharded, load_checkpoint,
                               load_sharded_checkpoint, save_checkpoint,
                               save_sharded_checkpoint)
from .utils.profiling import (EpochTrace, RooflineReport, SigmaRoundTrace,
                              XTrafficReport, debug_nans,
                              group_solve_with_trace,
                              lasso_sharded_with_trace, pass_roofline,
                              pass_roofline_multi, scaled_lasso_with_trace,
                              simple_timeit, solve_with_trace,
                              solve_x_traffic)
from .models.polish import (FeasiblePolishResult, GroupPolishResult,
                            PolishResult, ScaledPolishResult,
                            SqrtPolishResult, polish_feasible_lasso,
                            polish_group_lasso, polish_lasso,
                            polish_scaled_lasso, polish_sqrt_lasso)

__all__ = [
    "CDOptions", "IterLassoOptions", "ProxL1", "ProxZero", "soft_threshold",
    "LeastSquaresLoss", "WeightedLSLoss", "SqrtLassoLoss", "QuadraticLoss",
    "num_coordinates", "get_loadings", "get_sigma",
    "find_largest_correlations", "find_init_residuals", "find_init_sigma",
    "coordinate_descent", "lasso_duality_gap", "lasso_duality_gap_f64",
    "lasso_duality_gap_compensated",
    "lasso_kkt_residual", "sqrt_lasso_kkt_compensated", "loadings_f64",
    "LassoSolution", "lasso", "sqrt_lasso", "scaled_lasso", "feasible_lasso",
    "LassoPath", "lasso_path", "refit_lasso_path", "PolishResult",
    "polish_lasso", "SqrtPolishResult", "polish_sqrt_lasso",
    "ScaledPolishResult", "polish_scaled_lasso", "FeasiblePolishResult",
    "polish_feasible_lasso", "std_X", "sample_std", "gradient", "value",
    "ProxL1Group", "group_soft_threshold", "group_coordinate_descent",
    "group_lasso", "sym_num_coordinates", "sym_indices", "sym_pack",
    "sym_unpack", "symmetric_coordinate_descent",
    "group_lasso_kkt_compensated", "GroupPolishResult", "polish_group_lasso",
    "GaussianKernel", "EpanechnikovKernel", "SmoothingKernel",
    "create_kernel", "evaluate", "expand_X", "expand_wX", "expand_Xt_w_X",
    "expand_Xt_w_Y", "locpoly", "locpolyl1", "refit_locpolyl1",
    "lvocv_locpolyl1", "lvocv_locpoly", "split_locpoly", "get_beta",
    "get_nonzero_coordinates", "sparse_coefficients", "get_residuals",
    "get_standard_error", "get_standard_error_hew",
    "PathCheckpoint", "save_checkpoint", "load_checkpoint",
    "lasso_path_resumable", "EpochTrace", "SigmaRoundTrace",
    "RooflineReport", "XTrafficReport", "simple_timeit", "solve_with_trace",
    "scaled_lasso_with_trace", "group_solve_with_trace", "pass_roofline",
    "pass_roofline_multi", "solve_x_traffic", "debug_nans",
    "ShardedPathCheckpoint", "save_sharded_checkpoint",
    "load_sharded_checkpoint", "lasso_path_resumable_sharded",
    "lasso_sharded_with_trace",
]

__version__ = "0.1.0"
