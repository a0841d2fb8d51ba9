"""Plain solvers that the comparison holds the program to.

Plain PyTorch, written from the objectives alone: no import of the port
or of the JAX package, nothing the program made.  Each works in the
precision it is given (float64 for the reference; float32, with or
without TF32, for the controls that must fail the comparison).

- :func:`gram_lasso`: ``min ½ b'Kb − c'b + Σ t_j |b_j|`` for a batch of
  small Gram systems, by diagonally preconditioned FISTA with adaptive
  restart to a fixed point, then an exact solve on the support with the
  signs it found, kept where it satisfies every optimality condition.
- :func:`gram_group_lasso`: ``min ½ b'Kb − c'b + Σ_g t_g ‖b_g‖₂`` by FISTA
  with restart to a fixed point.
- :func:`lasso` and :func:`group_lasso`: ``min ‖y − Xb‖²/2 + n·λ·pen(b)``
  on a wide design by a working set: the Gram problem on the working set,
  then one pass of ``X'r`` over every column; columns (groups) that
  violate their optimality condition join the set, until none does.
"""

from __future__ import annotations

import torch

# X'r over this many columns at a time: bounds the widened copy of X to
# n x _COLS (655 MB at n = 10K in float64)
_COLS = 8192


def _tols(dtype):
    """(fixed-point tolerance, optimality slack) for a precision."""
    eps = torch.finfo(dtype).eps
    return (1e-13, 1e-10) if dtype == torch.float64 else (50 * eps, 1e-4)


def xtr(X, r):
    """``X'r`` for ``r`` in its own precision, X's columns widened to it a
    block at a time."""
    p = X.shape[1]
    if X.dtype == r.dtype:
        return X.T @ r
    return torch.cat([X[:, j:j + _COLS].to(r.dtype).T @ r
                      for j in range(0, p, _COLS)])


def _top_eig(K, iters: int = 60):
    """A bound above the largest eigenvalue of each symmetric PSD ``K``
    (m, d, d): power iteration, with a 10 % margin."""
    m, d, _ = K.shape
    g = torch.Generator(device=K.device).manual_seed(0)
    v = torch.rand((m, d, 1), generator=g, device=K.device,
                   dtype=K.dtype) + 0.5
    lam = torch.ones((m,), dtype=K.dtype, device=K.device)
    for _ in range(iters):
        u = K @ v
        lam = torch.linalg.vector_norm(u, dim=(1, 2))
        v = u / torch.clamp_min(lam, 1e-300)[:, None, None]
    return 1.1 * torch.clamp_min(lam, 1e-300)


def _soft(v, t):
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - t, 0.0)


def gram_lasso(K, c, t, b0=None, *, max_iter: int = 20000):
    """Solve ``min ½ b'Kb − c'b + Σ t_j |b_j|`` for each of ``m`` systems:
    ``K (m, d, d)``, ``c, t (m, d)``; returns ``b (m, d)``."""
    tol, slack = _tols(K.dtype)
    m, d, _ = K.shape
    s = torch.rsqrt(torch.clamp_min(torch.diagonal(K, dim1=1, dim2=2),
                                    1e-300))
    Kt = K * s[:, :, None] * s[:, None, :]
    ct, tt = c * s, t * s
    L = _top_eig(Kt)[:, None]
    x = (torch.zeros_like(c) if b0 is None else b0 / s)
    v, tk = x.clone(), torch.ones((m, 1), dtype=K.dtype, device=K.device)
    for it in range(max_iter):
        grad = (Kt @ v[:, :, None])[:, :, 0] - ct
        x_new = _soft(v - grad / L, tt / L)
        # gradient restart: the step went against the momentum
        bad = torch.sum((v - x_new) * (x_new - x), dim=1, keepdim=True) > 0
        t_new = 0.5 * (1 + torch.sqrt(1 + 4 * tk * tk))
        v = torch.where(bad, x_new, x_new + (tk - 1) / t_new * (x_new - x))
        tk = torch.where(bad, torch.ones_like(tk), t_new)
        moved = torch.amax(torch.abs(x_new - x), dim=1)
        x = x_new
        if it % 25 == 24:
            scale = torch.clamp_min(torch.amax(torch.abs(x), dim=1), 1e-300)
            if bool(torch.all(moved <= tol * scale)):
                break
    b = x * s
    # exact solve on the support with its signs: A_SS b_S = c_S − t_S σ_S
    sup = b != 0
    sg = torch.sign(b)
    eye = torch.eye(d, dtype=K.dtype, device=K.device).expand(m, d, d)
    A = torch.where(sup[:, :, None] & sup[:, None, :], K, eye)
    rhs = torch.where(sup, c - t * sg, torch.zeros_like(c))
    be, info = torch.linalg.solve_ex(A, rhs)
    g = c - (K @ be[:, :, None])[:, :, 0]
    ok = (info == 0) & torch.all(
        torch.where(sup, torch.sign(be) == sg,
                    torch.abs(g) <= t * (1 + slack)), dim=1)
    return torch.where(ok[:, None], be, b)


def _group_soft(v, t, G: int):
    m, d = v.shape
    vg = v.reshape(m, d // G, G)
    nrm = torch.linalg.vector_norm(vg, dim=2, keepdim=True)
    return (vg * torch.clamp_min(1 - t[:, :, None] / torch.clamp_min(
        nrm, 1e-300), 0.0)).reshape(m, d)


def gram_group_lasso(K, c, t, G: int, b0=None, *, max_iter: int = 20000):
    """Solve ``min ½ b'Kb − c'b + Σ_g t_g ‖b_g‖₂`` over consecutive groups
    of ``G`` for each of ``m`` systems: ``K (m, d, d)``, ``c (m, d)``,
    ``t (m, d/G)``; returns ``b (m, d)``."""
    tol, _ = _tols(K.dtype)
    m = K.shape[0]
    L = _top_eig(K)[:, None]
    x = torch.zeros_like(c) if b0 is None else b0.clone()
    v, tk = x.clone(), torch.ones((m, 1), dtype=K.dtype, device=K.device)
    for it in range(max_iter):
        grad = (K @ v[:, :, None])[:, :, 0] - c
        x_new = _group_soft(v - grad / L, t / L, G)
        bad = torch.sum((v - x_new) * (x_new - x), dim=1, keepdim=True) > 0
        t_new = 0.5 * (1 + torch.sqrt(1 + 4 * tk * tk))
        v = torch.where(bad, x_new, x_new + (tk - 1) / t_new * (x_new - x))
        tk = torch.where(bad, torch.ones_like(tk), t_new)
        moved = torch.amax(torch.abs(x_new - x), dim=1)
        x = x_new
        if it % 25 == 24:
            scale = torch.clamp_min(torch.amax(torch.abs(x), dim=1), 1e-300)
            if bool(torch.all(moved <= tol * scale)):
                break
    return x


def _working_set(X, y, thr, score, solve, grow: int, b_ws=None,
                 max_rounds: int = 60):
    """The working-set loop shared by :func:`lasso` and
    :func:`group_lasso`.  ``score(g) -> (viol, unit)``: each unit's
    (column's or group's) violation of its optimality condition given the
    full gradient ``g``; ``solve(cols, b0) -> b`` the restricted solve.
    Units are columns ``unit * width + arange(width)``."""
    n, p = X.shape
    dt = y.dtype
    _, slack = _tols(dt)
    beta = torch.zeros((p,), dtype=dt, device=X.device)
    units = (torch.zeros((0,), dtype=torch.long, device=X.device)
             if b_ws is None else b_ws)
    r = y
    solved = False
    for _ in range(max_rounds):
        viol, width = score(xtr(X, r))
        viol[units] = -1.0
        cand = torch.nonzero(viol > slack * thr).reshape(-1)
        if cand.numel() == 0 and (solved or units.numel() == 0):
            return beta, True
        if cand.numel():
            k = min(cand.numel(), max(grow, units.numel()))
            add = cand[torch.topk(viol[cand], k).indices]
            units = torch.cat([units, add])
        cols = (units[:, None] * width + torch.arange(
            width, device=X.device)[None, :]).reshape(-1)
        b = solve(cols, beta[cols])
        beta = torch.zeros_like(beta)
        beta[cols] = b
        r = y - X[:, cols].to(dt) @ b
        solved = True
    return beta, False


def lasso(X, y, lam: float, *, dtype=torch.float64, units=None):
    """``argmin ‖y − Xb‖²/2 + n·λ·‖b‖₁`` in ``dtype``; returns ``(b (p,),
    converged, units)``, ``units`` the final working set (a warm start for
    the next λ of a path)."""
    n = X.shape[0]
    yd = y.to(dtype)
    thr = n * float(lam)
    state = {}

    def score(g):
        return torch.abs(g) - thr, 1

    def solve(cols, b0):
        Xs = X[:, cols].to(dtype)
        K = Xs.T @ Xs
        c = Xs.T @ yd
        state["units"] = cols
        return gram_lasso(K[None], c[None], torch.full_like(c, thr)[None],
                          b0[None])[0]

    beta, ok = _working_set(X, yd, thr, score, solve, 256, units)
    return beta, ok, state.get("units")


def group_lasso(X, y, lam: float, G: int, *, dtype=torch.float64):
    """``argmin ‖y − Xb‖²/2 + n·λ·Σ_g ‖b_g‖₂`` over the contiguous groups
    of ``G`` columns (``p`` a multiple of ``G``) in ``dtype``; returns
    ``(b (p,), converged)``."""
    n, p = X.shape
    if p % G:
        raise ValueError(f"group_lasso reference: p = {p} is not a multiple "
                         f"of G = {G}")
    yd = y.to(dtype)
    thr = n * float(lam)

    def score(g):
        return torch.linalg.vector_norm(g.reshape(-1, G), dim=1) - thr, G

    def solve(cols, b0):
        Xs = X[:, cols].to(dtype)
        K = Xs.T @ Xs
        c = Xs.T @ yd
        t = torch.full((cols.numel() // G,), thr, dtype=dtype,
                       device=X.device)
        return gram_group_lasso(K[None], c[None], t[None], G, b0[None])[0]

    beta, ok = _working_set(X, yd, thr, score, solve, 16)
    return beta, ok
