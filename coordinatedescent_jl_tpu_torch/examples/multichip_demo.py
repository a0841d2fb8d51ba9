"""The multi-device tiers on a spawned world of ranks (counterpart of
``examples/multichip_demo.py``).

    python -m coordinatedescent_jl_tpu_torch.examples.multichip_demo [--cpu] [--small]

On the GPU machine the world has one rank a card, on NCCL; with ``--cpu``
four Gloo ranks on the CPU (two with ``--small``).  Every rank runs the
same calls (SPMD) and rank 0 prints.  In a program of your own, start the
ranks with ``torchrun`` and call ``parallel.initialize_distributed()`` in
each, or, as here, with ``parallel.distributed.launch`` under an ``if
__name__ == "__main__"`` guard (spawned ranks import the main module);
each rank may take its own column block through
``parallel.shard_design_matrix``.
"""

import os
import tempfile

import numpy as np
import torch

import coordinatedescent_jl_tpu_torch as tcd
from coordinatedescent_jl_tpu_torch import parallel as par
from coordinatedescent_jl_tpu_torch.examples import parse
from coordinatedescent_jl_tpu_torch.parallel import distributed as pdist


def rank_main(device, small):
    """Every rank: the sharded estimators on the same data."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    if device is None:                 # one card a rank
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    rng = np.random.default_rng(0)
    n, p, s = (300, 128, 10) if small else (500, 2000, 20)
    X = rng.standard_normal((n, p))
    beta_true = np.zeros(p)
    beta_true[rng.choice(p, s, replace=False)] = rng.standard_normal(s)
    y = X @ beta_true + 0.3 * rng.standard_normal(n)
    X, y = X.astype(np.float32), y.astype(np.float32)
    # float32 solves to 1e-6, the tolerance float32 reaches
    opts = tcd.CDOptions(opt_tol=1e-6)
    kw = dict(options=opts, device=device)
    ikw = dict(options=tcd.IterLassoOptions(options_cd=opts), device=device)

    mesh = par.feature_mesh()
    say(f"mesh: {tuple(mesh.mesh.shape)} over {world} rank(s), "
        f"{'the CPU' if device == 'cpu' else 'one card a rank'}")
    sol = par.lasso_sharded(X, y, 0.1, mesh, **kw)
    say(f"sharded lasso: nnz={int((sol.x != 0).sum())}, "
        f"σ̂={float(sol.sigma):.3f}")
    sc = par.scaled_lasso_sharded(X, y, float(np.sqrt(2 * np.log(p) / n)),
                                  mesh, **ikw)
    say(f"sharded scaled lasso (consensus σ): σ̂={float(sc.sigma):.3f}")
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.05), 10))
    path = par.lasso_path_sharded(X, y, lams, mesh, **kw)
    say(f"sharded warm path: {tuple(path.beta_path.shape)}")

    betas = par.lasso_lambda_batch(
        X, y, lams, pdist.make_mesh((world,), ("batch",)), **kw)
    say(f"batch-sharded independent λ grid: {tuple(betas.shape)}")
    # 2-D composition: λ scenarios over 'batch' × columns over 'feature'
    db = 2 if world % 2 == 0 else 1
    gmesh = par.grid_mesh(batch=db)
    bg = par.lasso_grid_sharded(X, y, lams[:4], gmesh, **kw)
    say(f"2-D (batch × feature) λ grid on {tuple(gmesh.mesh.shape)}: "
        f"{tuple(bg.shape)}")

    gsol = par.group_lasso_sharded(X, y, 0.15, 4, mesh, **kw)
    nzg = int(torch.any(gsol.x.reshape(-1, 4) != 0, dim=1).sum())
    say(f"sharded group lasso: {nzg} active groups")
    fs = par.feasible_lasso_sharded(X, y, 0.1, mesh, **ikw)
    say(f"sharded feasible lasso: nnz={int((fs.x != 0).sum())}")

    # checkpoint / resume of a warm path; every rank writes the same file,
    # so the directory comes from rank 0
    box = [tempfile.mkdtemp() if rank == 0 else None]
    dist.broadcast_object_list(box, src=0, device=(
        None if device == "cpu" else torch.device("cuda", rank)))
    ckpt = os.path.join(box[0], "path.npz")
    pr = tcd.lasso_path_resumable_sharded(X, y, lams, ckpt, mesh, **kw)
    say(f"sharded resumable path: {tuple(pr.beta_path.shape)} (checkpoint "
        f"{os.path.basename(ckpt)})")

    # observation-sharded (data-parallel) tier: rows over the ranks
    omesh = pdist.obs_mesh()
    ro = par.lasso_row_sharded(X, y, 0.1, omesh, **kw)
    say(f"row-sharded lasso (obs axis): nnz={int((ro.x != 0).sum())}")
    rp = par.lasso_path_row_sharded(X, y, lams, omesh, **kw)
    say(f"row-sharded warm path: {tuple(rp.beta_path.shape)}")
    # tile-sharded: X split over both axes of a 2-D mesh
    tmesh = pdist.make_mesh((db, world // db), ("obs", "feature"))
    ts = par.lasso_tile_sharded(X, y, 0.1, tmesh, **kw)
    say(f"tile-sharded lasso on {tuple(tmesh.mesh.shape)}: "
        f"nnz={int((ts.x != 0).sum())}")
    dist.barrier()
    if rank == 0:
        os.remove(ckpt)
        os.rmdir(box[0])


def main(argv=None):
    args = parse(__doc__, argv)
    if args.cpu:
        ranks, backend = (2 if args.small else 4), "gloo"
    else:
        if not torch.cuda.is_available():
            raise SystemExit("multichip_demo: no CUDA device (pass --cpu)")
        ranks, backend = torch.cuda.device_count(), "nccl"
    pdist.launch(rank_main, ranks, args.device, args.small, backend=backend,
                 timeout=600)


if __name__ == "__main__":
    main()
