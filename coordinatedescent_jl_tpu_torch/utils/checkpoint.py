"""Checkpoint / resume for long regularization paths (counterpart of
``coordinatedescent_jl_tpu/utils/checkpoint.py``): the single-device path
and the feature-sharded one (``lasso_path_resumable_sharded``, the file
gathered and written by one rank, read by it and broadcast).

The checkpoint persists the full solver state — β, the residuals, the
cached gradient ``c`` and its ``drift`` bounds, the active mask, the
visit-order generator, the working-set indices and the secant start's
previous point — so a resumed run follows the uninterrupted one's
trajectory bit for bit, also with ``randomize=True`` and with compaction:
every kernel adds in a fixed order (no atomics), so the same state gives
the same next state.  ``PathCheckpoint`` is written with ``numpy.savez``
(one array per field).

The generator is the port's ``torch.Generator`` (CPU), persisted with
``get_state()`` as a uint8 array and restored with ``set_state()``; a
file whose ``key`` is not such a state (one written by the JAX package
holds a (2,) uint32 key) loads as ``None`` and the run restarts.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.lasso_path import LassoPath
from ..ops.block_cd import (_compact_mode, _empty_ws_cache, _init_state,
                            _np_dtype, _path_point, _to_blocked_beta,
                            _ws_cache_from_idx, build_blocked,
                            full_f32_matmuls)
from . import host
from .helpers import on_device, std_X, target_device
from .options import CDOptions, resolve_extrapolate


class PathCheckpoint(NamedTuple):
    """Resumable warm-start state of a λ-path solve.  The transient
    per-solve counters ``it``/``conv``/``done`` are reset by every solve
    and need no persistence."""

    lam_path: np.ndarray     # full λ grid (identifies the run)
    next_index: int          # first unsolved path point
    beta_path: np.ndarray    # (num_solved, p) solved coefficients
    beta_warm: np.ndarray    # (p,) warm-start iterate for next_index
    residuals: np.ndarray    # (n,) residuals at beta_warm
    sigma: float             # running σ estimate (std of the residuals)
    key: np.ndarray          # torch.Generator state (uint8) of visit orders
    c: np.ndarray            # (nb, B) cached gradient (λ-independent)
    drift: np.ndarray        # (nb,) staleness bound on each block of c
    active: np.ndarray       # (nb,) active-block mask
    ws_idx: np.ndarray       # (C,) int64 compaction working-set indices
                             # (empty when compaction is off; the gathered
                             # columns are a deterministic re-gather)
    ws_ok: bool              # whether ws_idx holds a real gather
    beta_prev: np.ndarray    # (p,) previous point's solution: the secant
                             # start's second support point
    lam_k: float             # abscissa of beta_warm's path point
    lam_km1: float           # abscissa of beta_prev's path point


def save_checkpoint(path: str, ck: PathCheckpoint) -> None:
    """Atomic write (tmp + rename) of the checkpoint."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{f: np.asarray(v) for f, v in ck._asdict().items()})
    os.replace(tmp, path)


def _generator(state) -> Optional[torch.Generator]:
    """A CPU generator set to ``state``, or ``None`` when ``state`` is not
    a ``torch.Generator`` state."""
    state = np.asarray(state)
    if state.dtype != np.uint8 or state.ndim != 1:
        return None
    gen = torch.Generator()
    try:
        gen.set_state(torch.from_numpy(state.copy()))
    except RuntimeError:
        return None
    return gen


def load_checkpoint(path: str) -> Optional[PathCheckpoint]:
    """The checkpoint in ``path``, or ``None`` when there is none, a field
    is missing (an older or foreign file) or ``key`` is not a generator
    state: the caller then restarts rather than crash mid-resume."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if any(f not in z.files for f in PathCheckpoint._fields):
            return None
        if _generator(z["key"]) is None:
            return None
        return PathCheckpoint(
            lam_path=z["lam_path"],
            next_index=int(z["next_index"]),
            beta_path=z["beta_path"],
            beta_warm=z["beta_warm"],
            residuals=z["residuals"],
            sigma=float(z["sigma"]),
            key=z["key"],
            c=z["c"],
            drift=z["drift"],
            active=z["active"],
            ws_idx=z["ws_idx"],
            ws_ok=bool(z["ws_ok"]),
            beta_prev=z["beta_prev"],
            lam_k=float(z["lam_k"]),
            lam_km1=float(z["lam_km1"]),
        )


def lasso_path_resumable(X, y, lam_path, checkpoint_file: str,
                         options: CDOptions = CDOptions(), *,
                         standardize_X: bool = True, seed: int = 0,
                         checkpoint_every: int = 1,
                         device=None) -> LassoPath:
    """Warm-started Lasso path with per-point checkpointing.

    The same trajectory as the scan of ``lasso_path`` (``path_batch=0``;
    both step with ``ops/block_cd.py::_path_point``: the carried state and
    working-set cache, the secant start), but every ``checkpoint_every``
    points and at the last one the full warm-start state is saved to
    ``checkpoint_file``; a re-run with the same grid resumes at the first
    unsolved point and continues exactly as the uninterrupted run would
    have (a different grid, or an unreadable file, restarts).  Each save
    reads the state to the host in two counted reads (``utils/host.py``:
    the floating fields with the path's new rows, then the mask and the
    working-set indices).  Runs on ``device`` (``None``: the GPU, raising
    when there is none; ``"cpu"`` for the plain path on the CPU)."""
    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    dev = target_device(device)
    X = on_device(X, dev)
    y = on_device(y, dev, X.dtype)
    dtype = X.dtype
    n, p = X.shape
    B = options.block_size
    lam_np = np.asarray(lam_path, dtype=_np_dtype(dtype))
    L = lam_np.shape[0]
    n_scale = float(n)
    betas = []        # the solved points, on the device
    # the same on the host, as far as the last save: rows of one buffer,
    # so a save writes a view instead of stacking the rows again
    path_np = np.empty((L, p), dtype=lam_np.dtype)
    n_saved = 0
    with full_f32_matmuls():
        lamw = (std_X(X) if standardize_X
                else torch.ones((p,), dtype=dtype, device=dev))
        prob = build_blocked("ls", options, lamw, X=X, y=y)
        nb = prob.lamw.shape[0]
        nc = _compact_mode("ls", options, prob, dtype)
        cache = _empty_ws_cache("ls", prob, nc, options) if nc else None
        extrap = bool(nc) and resolve_extrapolate(options, False)
        zero = _to_blocked_beta(torch.zeros((p,), dtype=dtype, device=dev),
                                B)

        def blocked(v):
            return _to_blocked_beta(on_device(v, dev, dtype), B)

        ck = load_checkpoint(checkpoint_file)
        if ck is not None and (ck.lam_path.shape == lam_np.shape
                               and np.allclose(ck.lam_path, lam_np)):
            start = n_saved = ck.next_index
            path_np[:start] = ck.beta_path
            betas = list(on_device(ck.beta_path, dev, dtype).reshape(-1, p))
            if nc and ck.ws_idx.shape[0] == nc * B:
                # the gathered columns are a deterministic function of
                # (X, ws_idx): rebuilding them restores the cache exactly
                cache = _ws_cache_from_idx(
                    "ls", prob, nc, options,
                    on_device(ck.ws_idx, dev, torch.int64), bool(ck.ws_ok))
            st = _init_state("ls", prob, zero, _generator(ck.key))._replace(
                beta=blocked(ck.beta_warm),
                r=on_device(ck.residuals, dev, dtype),
                c=on_device(ck.c, dev, dtype),
                drift=on_device(ck.drift, dev, dtype),
                active=on_device(ck.active, dev, torch.bool))
            secant = (blocked(ck.beta_prev), ck.lam_k, ck.lam_km1)
        else:
            start = 0
            st = _init_state("ls", prob, zero,
                             torch.Generator().manual_seed(seed))
            # both abscissae start at the first point, as in the scan, so
            # the first two points skip the shift
            lam0 = float(lam_np[0]) if L else 0.0
            secant = (st.beta, lam0, lam0)

        def save(next_index):
            nonlocal n_saved
            beta_prev, lam_k, lam_km1 = secant
            new = betas[n_saved:]
            flat = host.numpy(torch.cat([*new, st.r, st.c.reshape(-1),
                                         st.drift,
                                         beta_prev.reshape(-1)[:p]]))
            ints = host.numpy(torch.cat([
                st.active.to(torch.int64),
                cache.idx if cache is not None
                else torch.zeros((0,), dtype=torch.int64, device=dev)]))
            k = len(new) * p
            path_np[n_saved:next_index] = flat[:k].reshape(-1, p)
            n_saved = next_index
            r_np, c_np, drift_np, prev_np = np.split(
                flat[k:], np.cumsum([n, nb * B, nb]))
            save_checkpoint(checkpoint_file, PathCheckpoint(
                lam_path=lam_np, next_index=next_index,
                beta_path=path_np[:next_index],
                beta_warm=path_np[next_index - 1], residuals=r_np,
                sigma=float(np.std(r_np)),
                key=st.key.get_state().numpy(),
                c=c_np.reshape(nb, B), drift=drift_np,
                active=ints[:nb].astype(bool), ws_idx=ints[nb:],
                ws_ok=cache is not None and cache.ok, beta_prev=prev_np,
                lam_k=float(lam_k), lam_km1=float(lam_km1)))

        for i in range(start, L):
            st, cache, secant = _path_point("ls", options, prob, st, cache,
                                            float(lam_np[i]), n_scale,
                                            secant, extrap)
            betas.append(st.beta.reshape(-1)[:p])
            if (i + 1) % checkpoint_every == 0 or i == L - 1:
                save(i + 1)
    return LassoPath(torch.as_tensor(lam_np, device=dev),
                     torch.stack(betas) if betas
                     else torch.zeros((0, p), dtype=dtype, device=dev))


# ---------------------------------------------------------------------------
# The feature-sharded path
# ---------------------------------------------------------------------------


class ShardedPathCheckpoint(NamedTuple):
    """Resumable state of a feature-sharded λ-path solve: the solver state
    gathered to global arrays (β, the residuals, the cached gradient ``c``
    and its ``drift``, the active mask) plus each shard's working set
    (``ws_idx``: shard-LOCAL indices, so a resume needs the same mesh
    shape, ``n_shards``; the gathered columns are a deterministic
    re-gather).  ``key`` holds the ranks' generator states (uint8 rows
    ``0 … n_shards − 1``, by feature rank) and, last, the replicated
    generator of the union round."""

    lam_path: np.ndarray     # full λ grid (identifies the run)
    next_index: int          # first unsolved path point
    beta_path: np.ndarray    # (num_solved, p) solved coefficients
    beta_warm: np.ndarray    # (p,) warm-start iterate for next_index
    residuals: np.ndarray    # (n,) replicated residuals at beta_warm
    key: np.ndarray          # (n_shards + 1, L) uint8 generator states
    c: np.ndarray            # (nb_total, B) cached gradient, all shards
    drift: np.ndarray        # (nb_total,) staleness bounds
    active: np.ndarray       # (nb_total,) active-block mask
    ws_idx: np.ndarray       # (n_shards, C) shard-local working-set indices
    ws_ok: np.ndarray        # (n_shards,) per-shard gather validity
    beta_prev: np.ndarray    # (p,) previous point (the secant's support)
    lam_k: float
    lam_km1: float
    n_shards: int            # mesh size the state was captured under


def save_sharded_checkpoint(path: str, ck: ShardedPathCheckpoint) -> None:
    """Atomic write (tmp + rename) of the sharded checkpoint."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{f: np.asarray(v) for f, v in ck._asdict().items()})
    os.replace(tmp, path)


def _sharded_keys_ok(key) -> bool:
    key = np.asarray(key)
    return (key.dtype == np.uint8 and key.ndim == 2
            and all(_generator(row) is not None for row in key))


def load_sharded_checkpoint(path: str) -> Optional[ShardedPathCheckpoint]:
    """The sharded checkpoint in ``path``, or ``None`` when there is none, a
    field is missing or ``key`` is not the ranks' generator states (a file
    the JAX package wrote holds a (2,) uint32 key: convert it with
    ``utils.convert.sharded_checkpoint_from_jax``)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if any(f not in z.files for f in ShardedPathCheckpoint._fields):
            return None
        if not _sharded_keys_ok(z["key"]):
            return None
        return ShardedPathCheckpoint(
            lam_path=z["lam_path"], next_index=int(z["next_index"]),
            beta_path=z["beta_path"], beta_warm=z["beta_warm"],
            residuals=z["residuals"], key=z["key"], c=z["c"],
            drift=z["drift"], active=z["active"], ws_idx=z["ws_idx"],
            ws_ok=z["ws_ok"], beta_prev=z["beta_prev"],
            lam_k=float(z["lam_k"]), lam_km1=float(z["lam_km1"]),
            n_shards=int(z["n_shards"]))


def lasso_path_resumable_sharded(X, y, lam_path, checkpoint_file: str,
                                 mesh, options: CDOptions = CDOptions(), *,
                                 standardize_X: bool = True,
                                 axis: str = "feature", seed: int = 0,
                                 checkpoint_every: int = 1,
                                 device=None) -> LassoPath:
    """Feature-sharded warm-started Lasso path with per-point checkpointing:
    point for point the scan of ``parallel.lasso_path_sharded``
    (``path_batch=0``), and every ``checkpoint_every`` points and at the
    last one the state is gathered and written by the axis's first rank.
    That rank also reads the file and broadcasts what it holds, so every
    rank resumes from the same state without a shared filesystem.  A
    resume on the same mesh shape is bit for bit the uninterrupted run
    (randomized orders included: the generators' states are saved); a
    checkpoint of another ``n_shards`` or grid restarts cleanly.  Every
    rank calls it with the same arguments and gets the path; ``device`` as
    the other sharded entry points."""
    import torch.distributed as dist

    from ..parallel._collectives import all_gather, broadcast_object
    from ..parallel.sharded_cd import (_gather_cols, _local_std, _own_vec,
                                       _sharded_init_state,
                                       _sharded_path_point, _setup,
                                       rank_generator)

    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    B = options.block_size
    su = _setup(X, mesh, axis, B, seed, device)
    sh, dev, dtype, n, p, chunk = su.sh, su.dev, su.dtype, su.n, su.p, su.chunk
    D = sh.D
    y = on_device(y, dev, dtype)
    lam_np = np.asarray(lam_path, dtype=_np_dtype(dtype))
    L = lam_np.shape[0]
    n_scale = float(n)
    validl = torch.arange(chunk, device=dev) + sh.s * chunk < p
    writer = dist.get_rank(sh.group) == 0
    with full_f32_matmuls():
        lamwl = (torch.where(validl, _local_std(su), 1.0) if standardize_X
                 else torch.ones((chunk,), dtype=dtype, device=dev))
        prob = build_blocked("ls", options, lamwl, X=su.Xl, y=y)
        del su
        nb = prob.lamw.shape[0]
        nc = _compact_mode("ls", options, prob, dtype)
        C = nc * B
        cache = _empty_ws_cache("ls", prob, nc, options) if nc else None
        extrap = bool(nc) and resolve_extrapolate(options, False)

        def own(v):                        # global (p,) → own blocked
            return _to_blocked_beta(_own_vec(on_device(v, dev, dtype), sh,
                                             chunk, 0.0), B)

        ck = load_sharded_checkpoint(checkpoint_file) if writer else None
        if ck is not None and not (
                ck.n_shards == D and ck.lam_path.shape == lam_np.shape
                and np.allclose(ck.lam_path, lam_np)
                and ck.key.shape[0] == D + 1):
            ck = None
        ck = broadcast_object(ck, sh.group)
        path_np = np.empty((L, p), dtype=lam_np.dtype)
        betas = []                           # own columns, on the device
        if ck is not None:
            start = n_saved = ck.next_index
            path_np[:start] = ck.beta_path
            betas = [own(row).reshape(-1) for row in ck.beta_path]
            sh.shared.set_state(torch.from_numpy(ck.key[D].copy()))
            if nc and ck.ws_idx.shape == (D, C):
                cache = _ws_cache_from_idx(
                    "ls", prob, nc, options,
                    on_device(ck.ws_idx[sh.s], dev, torch.int64),
                    bool(ck.ws_ok[sh.s]))
            blk = slice(sh.s * nb, (sh.s + 1) * nb)
            st = _sharded_init_state(
                "ls", prob, torch.zeros_like(prob.lamw),
                _generator(ck.key[sh.s]), sh)._replace(
                beta=own(ck.beta_warm),
                r=on_device(ck.residuals, dev, dtype),
                c=on_device(ck.c[blk], dev, dtype),
                drift=on_device(ck.drift[blk], dev, dtype),
                active=on_device(ck.active[blk], dev, torch.bool))
            secant = (own(ck.beta_prev), ck.lam_k, ck.lam_km1)
        else:
            start = n_saved = 0
            st = _sharded_init_state("ls", prob, torch.zeros_like(prob.lamw),
                                     rank_generator(seed, sh.s), sh)
            lam0 = float(lam_np[0]) if L else 0.0
            secant = (st.beta, lam0, lam0)

        def save(next_index):
            nonlocal n_saved
            beta_prev, lam_k, lam_km1 = secant
            rows = torch.stack(betas[n_saved:next_index])
            flat = torch.cat([_gather_cols(rows, sh)[:, :p].reshape(-1),
                              _gather_cols(beta_prev.reshape(-1), sh)[:p],
                              all_gather(st.c, sh.group).reshape(-1),
                              all_gather(st.drift, sh.group).reshape(-1)])
            ints = torch.cat([
                all_gather(st.active.to(torch.int64), sh.group).reshape(-1),
                all_gather(cache.idx if cache is not None else
                           torch.zeros((0,), dtype=torch.int64, device=dev),
                           sh.group).reshape(-1),
                all_gather(torch.tensor([int(cache is not None and cache.ok)],
                                        device=dev), sh.group).reshape(-1)])
            keys = all_gather(st.key.get_state().to(dev), sh.group)
            if not writer:
                return
            flat, ints = host.numpy(flat), host.numpy(ints)
            k = (next_index - n_saved) * p
            path_np[n_saved:next_index] = flat[:k].reshape(-1, p)
            n_saved = next_index
            prev_np, c_np, drift_np = np.split(flat[k:], np.cumsum([p, D * nb
                                                                    * B]))
            act_np, idx_np, ok_np = np.split(ints, np.cumsum([D * nb, D * C]))
            save_sharded_checkpoint(checkpoint_file, ShardedPathCheckpoint(
                lam_path=lam_np, next_index=next_index,
                beta_path=path_np[:next_index],
                beta_warm=path_np[next_index - 1],
                residuals=host.numpy(st.r),
                key=np.concatenate([keys.cpu().numpy(),
                                    sh.shared.get_state().numpy()[None]]),
                c=c_np.reshape(D * nb, B), drift=drift_np,
                active=act_np.astype(bool), ws_idx=idx_np.reshape(D, C),
                ws_ok=ok_np.astype(bool), beta_prev=prev_np,
                lam_k=float(lam_k), lam_km1=float(lam_km1), n_shards=D))

        for i in range(start, L):
            st, cache, secant = _sharded_path_point(
                options, prob, st, cache, float(lam_np[i]), n_scale, secant,
                extrap, sh)
            betas.append(st.beta.reshape(-1))
            if (i + 1) % checkpoint_every == 0 or i == L - 1:
                save(i + 1)
                if not writer:
                    n_saved = i + 1
        out = (_gather_cols(torch.stack(betas), sh)[:, :p] if betas
               else torch.zeros((0, p), dtype=dtype, device=dev))
    return LassoPath(torch.as_tensor(lam_np, device=dev), out)
