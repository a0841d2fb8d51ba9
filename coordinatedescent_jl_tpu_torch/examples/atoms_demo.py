"""Group atoms and symmetric-matrix iterates on the port (counterpart of
``examples/atoms_demo.py``).

The reference's ``coordinateDescent!`` accepts three iterate kinds
(coordinate_descent.jl:8):
plain sparse vectors, ``AtomIterate`` group atoms and
``SymmetricSparseIterate`` packed symmetric matrices.  This demo runs the
latter two:

    python -m coordinatedescent_jl_tpu_torch.examples.atoms_demo [--cpu] [--small]
"""

import numpy as np
import torch

import coordinatedescent_jl_tpu_torch as tcd
from coordinatedescent_jl_tpu_torch.examples import parse


def group_lasso_demo(device, small):
    rng = np.random.default_rng(0)
    n, p, G = (200, 512, 8) if small else (1000, 4096, 8)
    ng = p // G
    X = rng.standard_normal((n, p)).astype(np.float32)
    beta = np.zeros(p, np.float32)
    gsup = rng.choice(ng, 10, replace=False)
    for g in gsup:
        beta[g * G:(g + 1) * G] = rng.standard_normal(G)
    y = (X @ beta + 0.3 * rng.standard_normal(n)).astype(np.float32)

    sol = tcd.group_lasso(X, y, 0.05, G, device=device)
    b = sol.x.cpu().numpy().reshape(ng, G)
    found = np.nonzero(np.any(b != 0, axis=1))[0]
    print(f"group lasso on {sol.x.device}: {len(found)} active groups "
          f"(planted {len(gsup)}, recovered {len(set(found) & set(gsup))}), "
          f"σ̂={float(sol.sigma):.3f}")

    # the generic solver takes the group penalty directly (as the
    # reference's coordinateDescent! takes an AtomIterate)
    beta2, _ = tcd.coordinate_descent(
        torch.zeros(p), tcd.LeastSquaresLoss(torch.as_tensor(y),
                                             torch.as_tensor(X)),
        tcd.ProxL1Group(0.05, G), tcd.CDOptions(), device=device)
    print(f"coordinate_descent(ProxL1Group): max|Δ| vs group_lasso = "
          f"{float((beta2 - sol.x).abs().max()):.2e}")


def symmetric_demo(device, small):
    """Covariance thresholding over a symmetric iterate: minimize
    ½‖M − S‖_F² + λ‖M‖_{1,off} through the packed quadratic loss."""
    rng = np.random.default_rng(1)
    p = 16 if small else 64
    A = rng.standard_normal((p, 300)).astype(np.float32)
    S = torch.as_tensor((A @ A.T) / 300.0)
    lam = 0.1
    ij = tcd.sym_indices(p)
    off = (ij[:, 0] != ij[:, 1]).float()
    d = 1.0 + off                      # Frobenius multiplicities
    s = tcd.sym_pack(S)
    M, _ = tcd.symmetric_coordinate_descent(
        torch.zeros((p, p)), tcd.QuadraticLoss(torch.diag(d), -(d * s)),
        tcd.ProxL1(lam, 2.0 * off), tcd.CDOptions(opt_tol=1e-6),
        device=device)
    M = M.cpu()
    offm = ~torch.eye(p, dtype=torch.bool)
    print(f"symmetric thresholding: symmetric={bool(torch.equal(M, M.T))}, "
          f"off-diag sparsity={float((M[offm] == 0).float().mean()):.1%}, "
          f"diag preserved="
          f"{bool(torch.allclose(torch.diag(M), torch.diag(S), atol=1e-5))}")


def main(argv=None):
    args = parse(__doc__, argv)
    group_lasso_demo(args.device, args.small)
    symmetric_demo(args.device, args.small)


if __name__ == "__main__":
    main()
