"""Solver option records (counterpart of ``coordinatedescent_jl_tpu/utils/options.py``).

``CDOptions`` and ``IterLassoOptions`` keep every field and default of the
JAX package's records, so they convert 1:1 (``utils/convert.py``).  Fields
that steer the TPU hardware mapping keep their names and mean the nearest thing here:

- ``use_pallas`` selects the hand-written CUDA kernels (``kernels/``).
  ``None`` = on for CUDA tensors; ``True`` forces them and raises for CPU
  tensors; ``False`` takes the plain PyTorch path everywhere (the JAX
  package's own A/B switch).  No effect on solutions.
- ``fuse_check`` selects the fused check kernels (phase A/B) for the f32
  ls/wls full check.  The JAX package also gates them on a VMEM
  budget (``fused_check_fits``); the H100 has no such limit at the sizes
  this solver runs, so the port's gate is dtype only.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class CDOptions:
    """Options for the core coordinate-descent solver.

    Same fields and defaults as the JAX package's ``CDOptions`` (see its
    docstring for what each one does); ``use_pallas`` and ``fuse_check``
    are read as described in this module's docstring.
    """

    max_iter: int = 2000
    opt_tol: float = 1e-7
    randomize: bool = True
    warm_start: bool = True
    num_steps: int = 50
    block_size: int = 128
    use_pallas: bool | None = None
    stall_patience: int = 20
    inner: str = "auto"
    block_iters: int = 16
    screen: bool | None = None
    compact: bool | None = None
    compact_size: int = 1024
    compact_rounds: int = 32
    cache_gram: bool | None = None
    extrapolate: bool | None = None
    fuse_check: bool | None = None

    def replace(self, **kw) -> "CDOptions":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class IterLassoOptions:
    """Options for the outer loops of Scaled-Lasso and Feasible-Lasso (same
    fields and defaults as the JAX package's record): ``max_iter`` outer
    (σ / loading) rounds, ``opt_tol`` the relative tolerance on the outer
    fixed point, ``init_procedure`` one of ``'screening' | 'init_std' |
    'warm_start'``, ``s_init`` the screened columns of the initial σ /
    residual estimate, ``sigma_init`` the initial σ for ``'init_std'``,
    ``options_cd`` the inner solver's options."""

    max_iter: int = 20
    opt_tol: float = 1e-2
    init_procedure: str = "screening"
    s_init: int = 5
    sigma_init: float = 1.0
    options_cd: CDOptions = field(default_factory=CDOptions)

    def replace(self, **kw) -> "IterLassoOptions":
        return dataclasses.replace(self, **kw)


def resolve_extrapolate(options: CDOptions, consumer_default: bool) -> bool:
    """Resolve the tri-state ``extrapolate`` flag: an explicit user
    ``True``/``False`` wins; ``None`` takes the consumer's default (on for
    λ-continuation, off for dense λ paths, as in the JAX package)."""
    return (consumer_default if options.extrapolate is None
            else options.extrapolate)


def auto_batch_lanes(dtype, device, n_points: int | None = None,
                     min_points: int = 0) -> int:
    """Auto-default of the batched certify/refine execution (counterpart of
    the JAX package's ``auto_batch_lanes``): 128 lanes iff the dtype is
    narrower than float64, the tensors live on a CUDA device (the JAX
    package keys on a non-CPU backend: on a CPU the batched trade — more
    FLOPs for a shorter serial chain — loses) and the schedule has at
    least ``min_points`` entries; 0 (the sequential scan) otherwise."""
    if dtype.itemsize >= 8 or torch.device(device).type != "cuda":
        return 0
    if n_points is not None and n_points < min_points:
        return 0
    return 128


def use_kernels(options: CDOptions, t) -> bool:
    """The mode rule: hand-written kernels iff the tensors live on a CUDA
    device and the option allows them.  ``use_pallas=True`` with CPU
    tensors raises (there is no kernel to run there)."""
    if options.use_pallas is False:
        return False
    if t.is_cuda:
        return True
    if options.use_pallas is True:
        raise ValueError("use_pallas=True needs CUDA tensors: the hand-written "
                         "kernels run only on the GPU")
    return False
