"""Carry options and solver state across from the JAX package.

The parity tests feed identical state to both packages: these functions
take the JAX package's records (``CDOptions``, ``IterLassoOptions``,
``BlockedProblem``, ``CDState``, ``WsCache``, ``GroupProblem``,
``GroupState``, the smoothing kernels, a sharded path checkpoint) and
build the port's, on a given device and dtype.  They read the JAX arrays through ``numpy.asarray`` only, so this
module imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.block_cd import BlockedProblem, CDState, WsCache
from ..ops.group_cd import GroupProblem, GroupState
from ..models.varying_coefficient import EpanechnikovKernel, GaussianKernel
from .options import CDOptions, IterLassoOptions


def options_from_jax(opts) -> CDOptions:
    """A JAX ``CDOptions`` as the port's (same fields)."""
    return CDOptions(**dataclasses.asdict(opts))


def iter_options_from_jax(opts) -> IterLassoOptions:
    """A JAX ``IterLassoOptions`` as the port's (same fields; the inner
    ``options_cd`` through :func:`options_from_jax`)."""
    kw = {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)}
    kw["options_cd"] = options_from_jax(opts.options_cd)
    return IterLassoOptions(**kw)


def _t(a, device, dtype):
    if a is None:
        return None
    arr = np.asarray(a)
    t = torch.tensor(arr)
    if arr.dtype.kind == "f":
        t = t.to(dtype)
    return t.to(device)


def problem_from_jax(prob, device="cpu", dtype=torch.float64) -> BlockedProblem:
    """A JAX ``BlockedProblem`` of any kind as the port's: ``Xwb`` stays
    one tensor with ``Xb`` where the JAX record holds one array for both
    (ls, sqrt), is a second tensor where it is distinct (wls), and stays
    ``None`` in the quad layout (``Xb`` the blocks of ``A``, ``q`` set,
    no ``y``)."""
    Xb = _t(prob.Xb, device, dtype)
    if prob.Xwb is None:
        Xwb = None
    elif prob.Xwb is prob.Xb:
        Xwb = Xb
    else:
        Xwb = _t(prob.Xwb, device, dtype)
    return BlockedProblem(
        Xb=Xb, Xwb=Xwb,
        y=_t(prob.y, device, dtype), q=_t(prob.q, device, dtype),
        adiag=_t(prob.adiag, device, dtype), lamw=_t(prob.lamw, device, dtype),
        valid=_t(prob.valid, device, dtype), xwnorm=_t(prob.xwnorm, device,
                                                       dtype),
        Kb=_t(prob.Kb, device, dtype))


def state_from_jax(st, device="cpu", dtype=torch.float64,
                   key=None) -> CDState:
    """A JAX ``CDState`` as the port's (``rsqr``, the sqrt kind's running
    ``‖r‖²``, included); ``key`` is the port's generator (JAX PRNG keys do
    not carry over)."""
    return CDState(beta=_t(st.beta, device, dtype), r=_t(st.r, device, dtype),
                   rsqr=_t(st.rsqr, device, dtype),
                   active=_t(st.active, device, dtype), key=key,
                   it=int(np.asarray(st.it)), conv=bool(np.asarray(st.conv)),
                   done=bool(np.asarray(st.done)), c=_t(st.c, device, dtype),
                   drift=_t(st.drift, device, dtype))


def ws_cache_from_jax(cache, device="cpu", dtype=torch.float64) -> WsCache:
    """A JAX ``WsCache`` as the port's (indices as int64)."""
    return WsCache(idx=_t(cache.idx, device, dtype).to(torch.int64),
                   Xb=_t(cache.Xb, device, dtype),
                   Xwb=_t(cache.Xwb, device, dtype),
                   ok=bool(np.asarray(cache.ok)), Kb=_t(cache.Kb, device, dtype))


def group_problem_from_jax(prob, device="cpu",
                           dtype=torch.float64) -> GroupProblem:
    """A JAX ``GroupProblem`` as the port's: ``Xwb`` stays one tensor with
    ``Xb`` where the JAX record holds one array for both (ls, sqrt)."""
    Xb = _t(prob.Xb, device, dtype)
    Xwb = Xb if prob.Xwb is prob.Xb else _t(prob.Xwb, device, dtype)
    return GroupProblem(
        Xb=Xb, Xwb=Xwb, Kb=_t(prob.Kb, device, dtype),
        y=_t(prob.y, device, dtype), Lb=_t(prob.Lb, device, dtype),
        lamw=_t(prob.lamw, device, dtype), valid=_t(prob.valid, device,
                                                    dtype),
        xwnorm=_t(prob.xwnorm, device, dtype))


def group_state_from_jax(st, device="cpu", dtype=torch.float64,
                         key=None) -> GroupState:
    """A JAX ``GroupState`` as the port's; ``key`` is the port's generator
    (JAX PRNG keys do not carry over)."""
    return GroupState(beta=_t(st.beta, device, dtype),
                      r=_t(st.r, device, dtype),
                      active=_t(st.active, device, dtype), key=key,
                      it=int(np.asarray(st.it)),
                      conv=bool(np.asarray(st.conv)),
                      done=bool(np.asarray(st.done)))


def kernel_from_jax(kernel):
    """A JAX ``GaussianKernel`` or ``EpanechnikovKernel`` record as the
    port's (the bandwidth as a host float): the suite's only state."""
    kinds = {"GaussianKernel": GaussianKernel,
             "EpanechnikovKernel": EpanechnikovKernel}
    name = type(kernel).__name__
    if name not in kinds:
        raise TypeError(f"unsupported kernel: {type(kernel)!r}")
    return kinds[name](float(np.asarray(kernel.h)))


def sharded_checkpoint_from_jax(ck, seed: int = 0):
    """A JAX ``ShardedPathCheckpoint`` (the record, or the path of the
    ``.npz`` the JAX package wrote) as the port's: the same fields and
    mesh shape, ``ws_idx`` as int64; the JAX PRNG key does not carry over,
    so ``key`` holds fresh generator states seeded from ``(seed, rank)``
    and, last, the replicated generator's from ``seed`` (a randomized
    resume then draws other orders than the JAX run would; with
    ``randomize=False`` the resume follows the JAX trajectory)."""
    from ..parallel.sharded_cd import rank_generator
    from .checkpoint import ShardedPathCheckpoint

    if isinstance(ck, str):
        with np.load(ck) as z:
            fields = {f: z[f] for f in z.files}
    else:
        fields = {f: np.asarray(getattr(ck, f)) for f in ck._fields}
    D = int(fields["n_shards"])
    keys = [rank_generator(seed, s).get_state().numpy() for s in range(D)]
    keys.append(torch.Generator().manual_seed(seed).get_state().numpy())
    return ShardedPathCheckpoint(
        lam_path=fields["lam_path"], next_index=int(fields["next_index"]),
        beta_path=fields["beta_path"], beta_warm=fields["beta_warm"],
        residuals=fields["residuals"], key=np.stack(keys), c=fields["c"],
        drift=fields["drift"], active=fields["active"].astype(bool),
        ws_idx=fields["ws_idx"].astype(np.int64),
        ws_ok=fields["ws_ok"].astype(bool), beta_prev=fields["beta_prev"],
        lam_k=float(fields["lam_k"]), lam_km1=float(fields["lam_km1"]),
        n_shards=D)
