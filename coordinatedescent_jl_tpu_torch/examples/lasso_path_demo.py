"""A Lasso regularization path with diagnostics on the port (counterpart
of ``examples/lasso_path_demo.py``).

    python -m coordinatedescent_jl_tpu_torch.examples.lasso_path_demo [--cpu] [--small]
"""

import numpy as np
import torch

import coordinatedescent_jl_tpu_torch as tcd
from coordinatedescent_jl_tpu_torch.examples import parse


def main(argv=None):
    args = parse(__doc__, argv)
    dev = args.device
    rng = np.random.default_rng(0)
    n, p, s, L = (300, 256, 10, 20) if args.small else (2000, 10_000, 40, 50)
    X = rng.standard_normal((n, p)).astype(np.float32)
    beta_true = np.zeros(p, np.float32)
    support = rng.choice(p, s, replace=False)
    beta_true[support] = rng.standard_normal(s)
    y = (X @ beta_true + 0.5 * rng.standard_normal(n)).astype(np.float32)

    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    lam_max = float((yt @ Xt).abs().max()) / n
    lams = np.exp(np.linspace(np.log(0.8 * lam_max), np.log(0.05 * lam_max),
                              L))

    opts = tcd.CDOptions(opt_tol=1e-6)
    path = tcd.lasso_path(X, y, lams, options=opts, max_hat_s=4 * s,
                          device=dev)
    print(f"path on {path.beta_path.device}: {path.beta_path.shape[0]} points "
          f"(early-stopped at support > {4 * s})")
    Xd = path.beta_path.new_tensor(X)
    yd = path.beta_path.new_tensor(y)
    for i in [0, len(path.lam_path) // 2, len(path.lam_path) - 1]:
        b = path.beta_path[i]
        lam = float(path.lam_path[i])
        gap = float(tcd.lasso_duality_gap(Xd, yd, b, lam, tcd.std_X(Xd)))
        rec = len(set(torch.nonzero(b).flatten().tolist()) & set(support))
        print(f"  λ={lam:.4f}: nnz={int((b != 0).sum()):4d} "
              f"recovered {rec}/{s}, gap={gap:.2e}")

    refits = tcd.refit_lasso_path(path, X, y, device=dev)
    print(f"refits: {len(refits)} distinct supports")

    # batched execution: the endpoints run the scan, the rest refine in
    # chunks where one R@X sweep certifies the whole chunk
    pb = tcd.lasso_path(X, y, lams, options=opts, max_hat_s=4 * s,
                        path_batch=16, device=dev)
    if pb.beta_path.shape == path.beta_path.shape:
        agree = float((pb.beta_path - path.beta_path).abs().max())
        print(f"batched path: shape {tuple(pb.beta_path.shape)}, "
              f"max |Δ| vs scan = {agree:.1e}")
    else:
        print(f"batched path: truncation DIFFERS from scan "
              f"({tuple(pb.beta_path.shape)} vs "
              f"{tuple(path.beta_path.shape)})")

    beta, trace = tcd.solve_with_trace(X, y, float(lams[-1]), options=opts,
                                       device=dev)
    print(f"trace: converged in {len(trace.max_h)} epochs, final "
          f"maxH={trace.max_h[-1]:.1e}, gap={trace.duality_gap[-1]:.1e}")


if __name__ == "__main__":
    main()
