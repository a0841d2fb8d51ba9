"""Multi-rank dry run (counterpart of ``__graft_entry__.dryrun_multichip``):
one pass through every multi-device tier at tiny shapes in a world of
spawned ranks, each result checked finite (and the chunked scan equal to
the plain one bit for bit).

    python -m coordinatedescent_jl_tpu_torch.parallel.dryrun 4          # card
    python -m coordinatedescent_jl_tpu_torch.parallel.dryrun 4 --cpu    # CPU

The ranks run on the card unless the caller asks for the CPU: rank ``r``
on ``cuda:<r mod the cards>`` (Gloo; several ranks may share one card),
and without a GPU the dry run raises before it starts a rank.

The sequence is the JAX one: the λ grid on a 2-D ``("batch", "feature")``
mesh, a consensus-σ scaled Lasso on the feature mesh, the public grid
driver, the sharded group Lasso, the batched sharded path on the feature
mesh and on the 2-D mesh, the scan with ``scan_chunk`` against the plain
scan, and the row and tile tiers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..utils.options import CDOptions, IterLassoOptions
from .distributed import (feature_mesh, launch, make_mesh, obs_mesh,
                          rank_device)


def _finite(name, t, shape=None):
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise AssertionError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if not bool(torch.all(torch.isfinite(t))):
        raise AssertionError(f"{name}: non-finite values")


def _dryrun_rank(device):
    from . import (group_lasso_sharded, lasso_grid_sharded,
                   lasso_path_sharded, lasso_row_sharded, lasso_tile_sharded,
                   scaled_lasso_sharded)

    world = dist.get_world_size()
    if device is None:
        device = rank_device(
            f"cuda:{dist.get_rank() % torch.cuda.device_count()}")
    db = 2 if (world % 2 == 0 and world >= 4) else 1
    df = world // db
    mesh = make_mesh((db, df), ("batch", "feature"))
    fmesh = feature_mesh()
    opts = CDOptions(block_size=8, max_iter=20, opt_tol=1e-4,
                     randomize=False)
    n, p = 32, 8 * df * 2                 # two blocks per feature shard
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, p)).astype(np.float32)
    b = np.zeros(p, np.float32)
    b[:4] = rng.standard_normal(4)
    y = (X @ b + 0.1 * rng.standard_normal(n)).astype(np.float32)
    kw = dict(options=opts, device=device)

    # λ scenarios over 'batch', columns over 'feature' (two per row)
    out = lasso_grid_sharded(X, y, [0.3, 0.1] * db, mesh,
                             standardize_X=False, **kw)
    _finite("grid step", out, (2 * db, p))
    sol = scaled_lasso_sharded(
        X, y, 0.2, fmesh, options=IterLassoOptions(max_iter=2,
                                                   options_cd=opts),
        device=device)
    _finite("scaled", sol.x, (p,))
    betas = lasso_grid_sharded(X, y, [0.3, 0.2, 0.1], mesh,
                               standardize_X=False, **kw)
    _finite("grid", betas, (3, p))
    gsol = group_lasso_sharded(X, y, 0.2, 4, fmesh, **kw)
    _finite("group", gsol.x, (p,))
    lams = [0.4, 0.3, 0.2, 0.15, 0.1]
    path = lasso_path_sharded(X, y, lams, fmesh, standardize_X=False,
                              path_batch=2, coarse_stride=4, **kw)
    _finite("batched path", path.beta_path)
    path2 = lasso_path_sharded(X, y, lams, mesh, standardize_X=False,
                               path_batch=1, coarse_stride=4,
                               batch_axis="batch", **kw)
    _finite("batched path (2-D)", path2.beta_path)
    path_ck = lasso_path_sharded(X, y, lams, fmesh, standardize_X=False,
                                 path_batch=0, scan_chunk=2, **kw)
    path_mono = lasso_path_sharded(X, y, lams, fmesh, standardize_X=False,
                                   path_batch=0, **kw)
    if not torch.equal(path_ck.beta_path, path_mono.beta_path):
        raise AssertionError("scan_chunk changed the scan")
    rsol = lasso_row_sharded(X, y, 0.2, obs_mesh(), **kw)
    _finite("row", rsol.x, (p,))
    tsol = lasso_tile_sharded(X, y, 0.2, make_mesh((db, df),
                                                   ("obs", "feature")), **kw)
    _finite("tile", tsol.x, (p,))
    return (f"dryrun_multichip({world}): ok (mesh {db}x{df}, out "
            f"{tuple(out.shape)}, grid {tuple(betas.shape)}, group "
            f"nnz={int(torch.sum(gsol.x != 0))})")


def dryrun_multichip(n_ranks: int, device=None,
                     timeout: float = 120.0) -> str:
    """Run the dry run in a Gloo world of ``n_ranks`` spawned processes on
    ``device``: ``None``, the card (rank ``r`` on ``cuda:<r mod the
    cards>``; raises here without a GPU), or every rank on the one device
    given (``"cpu"``).  Raises when a rank fails or the world outlives
    ``timeout`` seconds.  Returns rank 0's summary line."""
    rank_device(device)                 # no GPU and no device="cpu": raise
    line = launch(_dryrun_rank, n_ranks, device, timeout=timeout)[0]
    print(line, flush=True)
    return line


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="multi-rank dry run")
    ap.add_argument("n_ranks", type=int, nargs="?", default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU (default: the card)")
    a = ap.parse_args()
    dryrun_multichip(a.n_ranks, device="cpu" if a.cpu else None)
