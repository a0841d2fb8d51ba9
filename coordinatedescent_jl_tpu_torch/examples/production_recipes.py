"""Production recipes on the port (counterpart of
``examples/production_recipes.py``): what a deployment needs on top of
the estimators.

1. run accounting for the certified batched execution (``stats={}``);
2. the 1e-7 duality-gap certificate of an f32 solve (``polish_lasso`` and
   ``lasso_duality_gap_compensated``), and the polishes of the other
   estimators;
3. ``scan_chunk``: the JAX package cuts its scan into device programs of
   that many points for runtimes that bound one program's time; the port
   takes the argument and ignores it (its scan is a host loop of short
   kernels), with the same result;
4. checkpoint and resume of an interrupted path (``lasso_path_resumable``).

    python -m coordinatedescent_jl_tpu_torch.examples.production_recipes [--cpu] [--small]
"""

import os
import tempfile

import numpy as np
import torch

import coordinatedescent_jl_tpu_torch as tcd
from coordinatedescent_jl_tpu_torch.examples import parse


def make_data(n, p, s, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    beta = np.zeros(p, np.float32)
    beta[rng.choice(p, s, replace=False)] = rng.standard_normal(s)
    y = (X @ beta + 0.5 * rng.standard_normal(n)).astype(np.float32)
    return torch.as_tensor(X), torch.as_tensor(y)


def main(argv=None):
    args = parse(__doc__, argv)
    dev = args.device
    X, y = make_data(*((300, 128, 10) if args.small else (2000, 4000, 40)))
    n, p = X.shape
    lam_max = float((y @ X).abs().max()) / n
    L = 16 if args.small else 40
    lams = lam_max * np.logspace(-0.1, -1.5, L)
    # float32 solves to 1e-6, the tolerance float32 reaches; the polishes
    # certify 1e-7 in float64
    opts = tcd.CDOptions(opt_tol=1e-6)

    # -- 1. certified batched path with run accounting ---------------------
    stats = {}
    path = tcd.lasso_path(X, y, lams, opts, stats=stats, device=dev)
    print(f"path on {path.beta_path.device}: {path.beta_path.shape[0]} "
          f"points, final nnz={int((path.beta_path[-1] != 0).sum())}, "
          f"stats={stats}")
    # stats['batched_certified'] False means the run fell back to the
    # sequential scan (the same solutions, more wall time): alert on it

    # -- 2. measurement-grade certification --------------------------------
    lam = float(lams[-1])
    sol = tcd.lasso(X, y, lam, options=opts, device=dev)
    gap0, primal0 = tcd.lasso_duality_gap_compensated(X, y, sol.x, lam,
                                                      device=dev)
    res = tcd.polish_lasso(X, y, sol.x, lam, target_rel_gap=1e-7, device=dev)
    print(f"certified: rel gap {gap0 / primal0:.2e} -> {res.rel_gap:.2e} in "
          f"{res.rounds} round(s), converged={res.converged}")
    lam_sq = 1.1 * float(np.sqrt(2 * np.log(p)))
    sq = tcd.sqrt_lasso(X, y, lam_sq, standardize_X=False, device=dev)
    rs = tcd.polish_sqrt_lasso(X, y, sq.x, lam_sq, device=dev)
    print(f"sqrt polish: kkt_rel {rs.kkt_rel:.1e} (converged={rs.converged})")
    lam_sc = float(np.sqrt(2 * np.log(p) / n))
    sc = tcd.scaled_lasso(X, y, lam_sc, device=dev)
    rsc = tcd.polish_scaled_lasso(X, y, sc.x, lam_sc, device=dev)
    print(f"scaled polish: rel_gap {rsc.rel_gap:.1e}, σ consistent to "
          f"{rsc.sigma_rel_change:.1e}")

    # -- 3. scan_chunk: taken and ignored ----------------------------------
    chunked = tcd.lasso_path(X, y, lams, opts, path_batch=0, scan_chunk=10,
                             device=dev)
    full = tcd.lasso_path(X, y, lams, opts, path_batch=0, device=dev)
    print(f"scan_chunk: the port takes the argument and ignores it (its scan "
          f"is a host loop of short kernels, no device program runs long); "
          f"the same path as without it: "
          f"{bool(torch.equal(chunked.beta_path, full.beta_path))}")

    # -- 4. checkpoint / resume --------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "path.npz")
        tcd.lasso_path_resumable(X, y, lams[:L // 2], ckpt, opts, device=dev)
        first = tcd.load_checkpoint(ckpt)
        # the interrupted run's grid extended: the resume solves the rest
        tcd.save_checkpoint(ckpt, first._replace(lam_path=np.asarray(
            lams, first.lam_path.dtype)))
        resumed = tcd.lasso_path_resumable(X, y, lams, ckpt, opts,
                                           device=dev)
        print(f"resume: {resumed.beta_path.shape[0]} points, the first "
              f"{first.next_index} from the checkpoint")


if __name__ == "__main__":
    main()
