"""Time K1 (every form), K2, K3/K4 and K5 at the main paths' shapes, for an
A/B of two trees.

    python -m coordinatedescent_jl_tpu_torch.kernel_ab
    PYTHONPATH=<other tree> python <this tree>/coordinatedescent_jl_tpu_torch/kernel_ab.py

The second form times the kernels of the package found first on the path
(another checkout, e.g. the parent commit), through the wrapper functions
both trees have.  Shapes and inputs are ``chip_smoke.py``'s, from the bench
problem (``profile_paths.bench_problem``, seed 0): K1 in float32 with the
FISTA inner over the scan's 8-block working set (8 active blocks, and 1),
its wls form there with random positive row weights (``K1wls``, and
``K1wls_nogram`` without cached Grams) and its sqrt form (``K1sqrt`` FISTA,
``K1sqrt_exact``) where the tree under test has them, ``K1sqrt_f64`` (exact)
on the sqrt polish's inner-solve blocks,
K1 without a Gram over the full design's active blocks, K1 in float64
(exact inner) on the polish's inner-solve block, and K5 on the working
set, on the full blocked design and in its float64-accumulating form on
the dense design, each beside ``torch.matmul``'s time where one call
computes the same function; K2 on the full design with ~30 % of the blocks
needed (``K2_blocks`` of them, ``K2_bound_ms`` its byte bound); the check
phases on the full design's
mid-solve state (fresh ``c``, a drift on half of the blocks): ``K3``
(phase A, screen on), ``K3_noscreen`` and ``K4`` (phase B with phase A's
masks); ``K1p`` (the JAX package's resident pass K1′: K1's small-n plan,
wls, FISTA, one block of 128 with a cached Gram at n = 500, from 0.9 of
the solution at z0 = 0.5 of the varying-coefficient bench problem, where
the tree under test has it); ``lasso_counts``, the host reads and the
launches of ``chip_smoke.py`` 4c's warm ``lasso`` at 0.05·λmax·(1 + 2e-7)
(after a warm-up), which tell a tree's host-side changes apart from its
kernels'.  Per call: milliseconds between CUDA events
around back-to-back calls, the host's time to issue a call, the device
kernels' time and count from ``torch.profiler``, and ``cdt_ms`` the device
time of the port's own kernels alone (a wrapper's allocations, copies and
sorts are other kernels; events and host time are medians of five runs);
one JSON line, after the card's name and power limit.  Needs a CUDA GPU.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch


def _ms(fn, reps: int, rounds: int = 5) -> dict:
    """Per call: ``ms`` between CUDA events around ``reps`` calls (what a
    caller waits) and ``host_ms`` the host's time to make one call, each
    the median of ``rounds`` such runs (the host's time varies between
    runs on a shared machine); ``dev_ms`` the device kernels' time in a
    profiler trace and ``kernels`` their number."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    ev, hs = [], []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        hs.append(time.perf_counter() - t0)
        end.record()
        torch.cuda.synchronize()
        ev.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"ms": statistics.median(ev) / reps,
            "host_ms": statistics.median(hs) * 1e3 / reps,
            "dev_ms": sum(e.time_range.elapsed_us() for e in kern)
            * 1e-3 / reps,
            "cdt_ms": sum(e.time_range.elapsed_us() for e in kern
                          if "cdt::" in e.name) * 1e-3 / reps,
            "kernels": len(kern) / reps}


def main():
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA GPU", file=sys.stderr)
        sys.exit(1)
    import coordinatedescent_jl_tpu_torch as tcd
    from coordinatedescent_jl_tpu_torch.kernels import active_pass as ap
    from coordinatedescent_jl_tpu_torch.kernels import check
    from coordinatedescent_jl_tpu_torch.kernels import gradient_sweep as gs
    from coordinatedescent_jl_tpu_torch.models import polish as pol
    from coordinatedescent_jl_tpu_torch.ops import block_cd
    from coordinatedescent_jl_tpu_torch.profile_paths import bench_problem

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bp = bench_problem(dev, seed=0)
    X, y, support, beta_true = bp.X, bp.y, bp.support, bp.beta_true
    (n, p), B = X.shape, 128
    lam0 = 0.05 * bp.lammax
    g = torch.Generator(device=dev).manual_seed(1)
    out = {"package": tcd.__file__}

    cols = torch.unique(torch.cat([support, torch.randperm(
        p, generator=g, device=dev)[:1024]]))[:1024]
    ws = block_cd.build_blocked("ls", bp.opts.replace(cache_gram=True),
                                torch.ones(1024, device=dev),
                                X=X[:, cols].contiguous(), y=y)
    st = block_cd._init_state("ls", ws, (0.9 * beta_true[cols]).reshape(
        8, B).contiguous(), None)
    border8, corder = torch.arange(8, device=dev), torch.arange(B, device=dev)
    for key, act in (("K1_8", torch.ones(8, dtype=torch.bool, device=dev)),
                     ("K1_1", border8 == 3)):
        args = (ws, st.beta, st.r, act, lam0, float(n), border8, corder)
        out[key] = _ms(lambda: ap.fused_active_pass(
            *args, inner="ista", iters=16, rsqr=st.rsqr), 50)
    # the wls and sqrt forms (trees from before them have no LAUNCHES_KIND)
    kinds = hasattr(ap, "LAUNCHES_KIND")
    lam_sq = 1.1 * math.sqrt(2 * math.log(p))
    if kinds:
        act8 = torch.ones(8, dtype=torch.bool, device=dev)
        Xc = X[:, cols].contiguous()
        w = 0.5 + torch.rand(n, generator=g, device=dev)
        for key, gram in (("K1wls", True), ("K1wls_nogram", False)):
            pw = block_cd.build_blocked(
                "wls", bp.opts.replace(cache_gram=gram, compact=False),
                torch.ones(1024, device=dev), X=Xc, y=y, w=w)
            sw = block_cd._init_state("wls", pw, st.beta, None)
            args = (pw, sw.beta, sw.r, act8, lam0, float(n), border8, corder)
            out[key] = _ms(lambda: ap.fused_active_pass(
                *args, kind="wls", inner="ista", iters=16, rsqr=sw.rsqr), 50)
        ps = block_cd.build_blocked("sqrt", bp.opts.replace(cache_gram=True),
                                    torch.ones(1024, device=dev), X=Xc, y=y)
        ss = block_cd._init_state("sqrt", ps, st.beta, None)
        args = (ps, ss.beta, ss.r, act8, lam_sq, float(n), border8, corder)
        for key, inner in (("K1sqrt", "ista"), ("K1sqrt_exact", "exact")):
            out[key] = _ms(lambda: ap.fused_active_pass(
                *args, kind="sqrt", inner=inner, iters=16, rsqr=ss.rsqr), 50)
        del pw, sw, ps, ss, Xc
    out["K5_ws"] = _ms(lambda: gs.fused_gradient_sweep(ws.Xwb, st.r), 100)
    out["K5_ws_matmul"] = _ms(lambda: torch.matmul(st.r, ws.Xwb), 100)
    del ws, st

    sol = tcd.lasso(X, y, lam0)
    sup = torch.nonzero(sol.x).flatten()
    C = pol._allocation(sup.numel(), p, 4096)
    idx = torch.full((C,), p, dtype=torch.int64, device=dev)
    idx[:sup.numel()] = sup
    b64 = torch.zeros((C,), dtype=torch.float64, device=dev)
    b64[:sup.numel()] = sol.x[sup].double()
    prob64, st64, _ = pol._restricted_problem(
        X, y.double(), torch.ones(p, dtype=torch.float64, device=dev), idx,
        b64)
    nb64 = prob64.lamw.shape[0]
    args = (prob64, st64.beta, st64.r, st64.active, lam0, float(n),
            torch.arange(nb64, device=dev), corder)
    out["K1f64"] = _ms(lambda: ap.fused_active_pass(
        *args, inner="exact", rsqr=st64.rsqr), 50)
    if kinds:
        args = (prob64, st64.beta, st64.r, st64.active, lam_sq, float(n),
                torch.arange(nb64, device=dev), corder)
        rs64 = torch.dot(st64.r, st64.r)
        out["K1sqrt_f64"] = _ms(lambda: ap.fused_active_pass(
            *args, kind="sqrt", inner="exact", rsqr=rs64), 50)
    del prob64, st64, args, sol

    full = block_cd.build_blocked("ls", bp.opts, torch.ones(p, device=dev),
                                  X=X, y=y)
    st = block_cd._init_state("ls", full, block_cd._to_blocked_beta(
        0.9 * beta_true, B).contiguous(), None)
    nbf = full.lamw.shape[0]
    args = (full, st.beta, st.r, st.active, lam0, float(n),
            torch.arange(nbf, device=dev), corder)
    out["K1_full_nogram"] = _ms(lambda: ap.fused_active_pass(
        *args, inner="ista", iters=16, rsqr=st.rsqr), 5)
    out["K5"] = _ms(lambda: gs.fused_gradient_sweep(full.Xwb, st.r), 20)
    out["K5_matmul"] = _ms(lambda: torch.matmul(st.r, full.Xwb), 20)
    g2 = torch.Generator(device=dev).manual_seed(2)
    need = torch.rand(nbf, generator=g2, device=dev) < 0.3
    c_prev = torch.randn((nbf, B), generator=g2, device=dev)
    nn = int(need.sum())
    out["K2"] = _ms(lambda: gs.restricted_gradient_sweep(
        full.Xwb, st.r, need, c_prev, n_need=nn), 20)
    out["K2_blocks"] = nn
    out["K2_bound_ms"] = 4 * (nn * n * B + n + 2 * nbf * B) / 3.35e9
    c_full = block_cd._full_gradient_c("ls", full, st.r, kernels=False)
    drift = torch.where(torch.rand(nbf, generator=g, device=dev) < 0.5,
                        torch.rand(nbf, generator=g, device=dev) * 1e-3,
                        torch.zeros(nbf, device=dev))
    scal = block_cd._check_scalars(lam0, float(n), torch.dot(st.r, st.r),
                                   torch.dot(st.r, y), 1e-6)
    a_args = (c_full, st.beta, drift, full.adiag, full.lamw,
              full.valid.float(), full.xwnorm, scal)
    out["K3"] = _ms(lambda: check.check_phase_a(*a_args, screen=True), 200)
    out["K3_noscreen"] = _ms(
        lambda: check.check_phase_a(*a_args, screen=False), 200)
    _, ub, cand, bound, _, _ = check.check_phase_a(*a_args, screen=True)
    b_args = (c_full, st.beta, bound, ub, cand, *a_args[3:])
    out["K4"] = _ms(lambda: check.check_phase_b(*b_args), 200)
    del full, st, args, c_full, a_args, b_args, bound
    torch.cuda.empty_cache()

    r64 = y.double() - X[:, support].double() @ beta_true[support].double()
    out["K5f64"] = _ms(lambda: gs.grad_f64(X, r64), 20)
    del r64

    from coordinatedescent_jl_tpu_torch.profile_paths import (
        launch_counts, reset_launch_counts)
    from coordinatedescent_jl_tpu_torch.utils import host

    lam_t = float(bp.lams[-1]) * (1.0 + 2e-7)
    tcd.lasso(X, y, lam_t)
    reset_launch_counts()
    host.reset()
    tcd.lasso(X, y, lam_t)
    out["lasso_counts"] = {"host_reads": host.COUNTS["host_reads"],
                           "epochs": host.COUNTS["epochs"],
                           **{k: v for k, v in launch_counts().items() if v}}
    del X, y, bp
    torch.cuda.empty_cache()
    if hasattr(tcd, "GaussianKernel"):
        out["K1p"] = _k1_resident(tcd, ap, block_cd, dev)
    print(json.dumps(out), flush=True)


def _k1_resident(tcd, ap, block_cd, dev) -> dict:
    """K1's small-n plan (K1′) on one varying-coefficient grid point, as
    ``chip_smoke.py`` builds it."""
    from coordinatedescent_jl_tpu_torch.profile_paths import vc_bench_problem

    vp = vc_bench_problem(dev)
    B, nv = 128, vp.X.shape[0]
    w = tcd.evaluate(tcd.GaussianKernel(vp.h), vp.z, 0.5)
    eX = tcd.expand_X(vp.X, vp.z, 0.5, vp.degree)
    opts = tcd.CDOptions()
    lamw = tcd.std_X(eX, w)
    prob = block_cd.build_blocked("wls", opts, lamw, X=eX, y=vp.y, w=w)
    b, _ = tcd.coordinate_descent(torch.zeros(eX.shape[1], device=dev),
                                  tcd.WeightedLSLoss(vp.y, eX, w),
                                  tcd.ProxL1(vp.lam0, lamw), opts)
    st = block_cd._init_state("wls", prob, block_cd._to_blocked_beta(
        0.9 * b, B).contiguous(), None)
    args = (prob, st.beta, st.r, torch.ones(1, dtype=torch.bool, device=dev),
            vp.lam0, float(nv), torch.arange(1, device=dev),
            torch.arange(B, device=dev))
    return _ms(lambda: ap.fused_active_pass(
        *args, kind="wls", inner="ista", iters=16, rsqr=st.rsqr), 50)


if __name__ == "__main__":
    main()
