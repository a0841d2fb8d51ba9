"""coordinatedescent_jl_tpu_torch: the PyTorch + CUDA port of
``coordinatedescent_jl_tpu`` for one NVIDIA H100.

The least-squares Lasso main path — ``lasso``, ``lasso_path`` (scan and
batched executions), ``coordinate_descent`` and the float64 polish
``polish_lasso`` with its compensated certificate — runs in PyTorch, with
the five TPU kernels on that path rewritten by hand for Hopper in CUDA C++
(``kernels/``, ``csrc/``).  The entry points run on the GPU unless the
caller passes ``device="cpu"``.  The kernels are built with ``nvcc`` at
first use on the machine with the GPU; importing the package needs no
GPU, no ``nvcc`` and no JAX.
"""

from .utils.options import CDOptions
from .utils.helpers import sample_std, std_X
from .ops.prox import ProxL1, soft_threshold
from .ops.losses import LeastSquaresLoss, num_coordinates
from .ops.block_cd import coordinate_descent
from .ops.compensated import lasso_duality_gap_compensated
from .ops.diagnostics import (lasso_duality_gap, lasso_duality_gap_f64,
                              lasso_kkt_residual)
from .models.lasso import LassoSolution, lasso
from .models.lasso_path import LassoPath, lasso_path
from .models.polish import PolishResult, polish_lasso

__all__ = [
    "CDOptions", "ProxL1", "soft_threshold", "LeastSquaresLoss",
    "num_coordinates", "coordinate_descent", "lasso_duality_gap",
    "lasso_duality_gap_f64", "lasso_duality_gap_compensated",
    "lasso_kkt_residual", "LassoSolution", "lasso", "LassoPath",
    "lasso_path", "PolishResult", "polish_lasso", "std_X", "sample_std",
]

__version__ = "0.1.0"
