"""Time K1 (every form), K2, K3/K4, K5, GP, the union-block round and the
varying-coefficient round at the main paths' shapes, for an A/B of two
trees.

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
masks); ``GP`` (the group engine's active pass at ``chip_smoke.py`` 4h's
shape: n = 10,000, blocks of 128 lanes in groups of 8, 12 of 16 blocks
active, 16 steps, float32) and ``UF`` (the batched path's union-block
FISTA round at 4b's: 98 lanes, Cp = 1,024, blocks of 128, 16 steps, 8
sweeps), where the tree under test has them; ``K1p`` (the JAX package's
resident pass K1′: K1's small-n plan,
wls, FISTA, one block of 128 with a cached Gram at n = 500, from 0.9 of
the solution at z0 = 0.5 of the varying-coefficient bench problem, where
the tree under test has it); ``VC`` and ``VC_f64`` (the
varying-coefficient grid's refine round at 4j's shape: 128 lanes, n =
500, p = 50, degree 1, 16 steps, float32 and float64, where the tree
under test has it); ``lasso_counts``, the host reads and the
launches of ``chip_smoke.py`` 4c's warm ``lasso`` at 0.05·λmax·(1 + 2e-7)
(after a warm-up), which tell a tree's host-side changes apart from its
kernels'.  Per call: milliseconds between CUDA events
around back-to-back calls, the host's time to issue a call, the device
kernels' time and count from ``torch.profiler``, and ``cdt_ms`` the device
time of the port's own kernels alone (a wrapper's allocations, copies and
sorts are other kernels; events and host time are medians of five runs);
one JSON line, after the card's name and power limit.  Every key also
carries ``by_kernel`` (each device kernel's ms per call, by name) and
``digest`` (a hash of the call's outputs: two trees that compute the same
bits print the same digest).  Needs a CUDA GPU.

    python -m coordinatedescent_jl_tpu_torch.kernel_ab --small

times the small-n regime alone, at ``chip_smoke.py``'s varying-coefficient
point (one wls block of 128 at n = 500, cached Gram): ``K1p`` (FISTA, 16
steps), ``K1p_iters0`` (no step: the launch, the sweep, the barrier, the
residual update), ``K1p_exact`` (the exact scan; ``K1p_exact_scan_dev_ms``
its device time less ``K1p_iters0``'s), ``K5p`` (K5 on that block) beside
``K5p_matmul`` (``torch.matmul``), ``K5ws`` / ``K5ws_matmul`` on the
working set's (8, 10,000, 128); where the tree has the routes (the
``plan=`` keyword): K1′ on each route at the plan's CTAs and rows
(``K1p_cluster_<inner>``, ``K1p_coop_<inner>``, with ``bitwise``
equality of the two routes' outputs) and FISTA at 4, 8, 16 (and, the
cooperative route, 32) CTAs (``K1p_<route>_G<G>``), K5 at (1, 500, 128) on every slice count S
of 1-16 (``K5p_S<S>``, the cluster route, and ``K5p_S3_two`` the
two-kernel route at S = 3, bitwise against the cluster's at S = 3), the
working set on a 16-slice cluster (``K5ws_S16``), and where the library
has K1's launch probe an empty launch of K1′'s CTAs and shared memory on
each route with 0, 1 and 2 barriers (``probe_coop_b<k>``,
``probe_cluster_b<k>``), and one that first copies the 64 KB Gram into
every CTA's shared memory (``probe_<route>_b1_gram``), and K1 over 8
blocks with cached Grams at n = 1,000, 2,000 and 4,096 on a 16-CTA
cluster and on the cooperative route's own plan (``K1n<n>_cluster``,
``K1n<n>_coop``); K3/K4 at that point and at 8 rows on every route the
tree has (:func:`_check_small`), and where the library has it an empty
launch of one CTA of the check's 256 threads (``probe_cta``: the one-CTA
route's floor).  ``--stamps``: K1′'s first
visit by phase on each route (:func:`stamps_main`).
"""

from __future__ import annotations

import hashlib
import json
import math
import statistics
import subprocess
import sys
import time

import torch


def _digest(out) -> str:
    """A hash of the bytes of a call's tensor outputs."""
    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(t, torch.Tensor):
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _program_range(name: str) -> bool:
    """A device-side copy of the port's own profiler ranges
    (``utils/host.py``'s ``cdt:`` spans and ``cdt#`` marks), not a
    kernel; named here since the tree under test may predate them."""
    return name.startswith("cdt#") or (name.startswith("cdt:")
                                       and not name.startswith("cdt::"))


def _short(name: str) -> str:
    """A device kernel's name without its template arguments' noise."""
    return name.split("(")[0].replace("void ", "")[:80]


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
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not _program_range(e.name)]
    by = {}
    for e in kern:
        by[_short(e.name)] = (by.get(_short(e.name), 0.0)
                              + e.time_range.elapsed_us() * 1e-3 / reps)
    return {"ms": statistics.median(ev) / reps,
            "digest": _digest(fn()), "by_kernel": by,
            "host_ms": statistics.median(hs) * 1e3 / reps,
            "dev_ms": sum(e.time_range.elapsed_us() for e in kern)
            * 1e-3 / reps,
            # a trace now and then loses a kernel's record: the mean of the
            # kernels it kept
            "dev_ms_per_kernel": sum(e.time_range.elapsed_us() for e in kern)
            * 1e-3 / max(len(kern), 1),
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
    out.update(_group_and_union(X, y, bp.opts, dev))

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
    out.update(_vc_round_keys(tcd, dev))
    print(json.dumps(out), flush=True)


def _vc_round_keys(tcd, dev) -> dict:
    """``VC`` / ``VC_f64``: one varying-coefficient refine round
    (``fused_vc_round``) at ``chip_smoke.py`` 4j's shape: 128 lanes of the
    bench problem's grid (n = 500, p = 50, degree 1, z0 evenly over [0.05,
    0.95]) at λ0 = 0.05, 16 steps, from random sparse starts (seed 22), in
    float32 (X in shared memory) and float64 (X from L2); only where the
    tree under test has the kernel."""
    try:
        from coordinatedescent_jl_tpu_torch.kernels import vc_round
    except ImportError:
        return {}
    from coordinatedescent_jl_tpu_torch.models import varying_coefficient
    from coordinatedescent_jl_tpu_torch.ops.block_cd import full_f32_matmuls
    from coordinatedescent_jl_tpu_torch.profile_paths import vc_bench_problem

    vp = vc_bench_problem(dev)
    out = {}
    for key, dt in (("VC", torch.float32), ("VC_f64", torch.float64)):
        X, z, y = (t.to(dt) for t in (vp.X, vp.z, vp.y))
        k, n = 128, X.shape[0]
        z0 = torch.linspace(0.05, 0.95, k, dtype=dt, device=dev)
        with full_f32_matmuls():
            ops = varying_coefficient._VcBatchOps(
                X, z, y, tcd.GaussianKernel(vp.h), z0, vp.degree,
                tcd.CDOptions())
        thrw = (ops.lamw * varying_coefficient._thr_scale(vp.lam0, n, dt)
                ).contiguous()
        g = torch.Generator(device=dev).manual_seed(22)
        B = 0.1 * torch.randn((k, ops.ep), generator=g, device=dev,
                              dtype=dt) * (torch.rand(
                                  (k, ops.ep), generator=g, device=dev) < 0.2)
        state = (B, torch.zeros((k,), dtype=torch.bool, device=dev),
                 torch.full((k,), float("inf"), dtype=dt, device=dev),
                 torch.zeros((k,), dtype=torch.int32, device=dev),
                 torch.zeros((k,), dtype=torch.bool, device=dev), thrw)
        out[key] = _ms(lambda: vc_round.fused_vc_round(ops, *state), 50)
        optin = torch.cuda.get_device_properties(
            dev).shared_memory_per_block_optin
        out[key]["route"] = vc_round.pick_route(
            n, X.shape[1], vp.degree + 1, X.element_size(), optin)
    return out


def _group_and_union(X, y, opts, dev) -> dict:
    """``GP``: one group pass (``fused_group_pass``) over the first 2,048
    columns of the bench design in groups of 8 (16 blocks of 128), 3
    random groups nonzero in each of the first 12 blocks, at a fifth of the
    groups' λmax.  ``UF``: one union-block round (``fused_union_fista``) as
    ``chip_smoke.py`` 4b builds it (seed 18) on the design's first 1,024
    columns.  Each only where the tree has its kernel."""
    import importlib

    def module(name):
        try:
            return importlib.import_module(
                f"coordinatedescent_jl_tpu_torch.kernels.{name}")
        except ImportError:
            return None

    from coordinatedescent_jl_tpu_torch.ops import group_cd
    try:
        from coordinatedescent_jl_tpu_torch.ops.prox import fista_momentum
    except ImportError:   # trees from before the one helper
        fista_momentum = group_cd._fista_coefs
    out = {}
    n = X.shape[0]
    gp, uf = module("group_pass"), module("union_fista")
    if gp is not None:
        G, Cg = 8, 2048
        gen = torch.Generator(device=dev).manual_seed(21)
        prob = group_cd._build_group_problem(
            X[:, :Cg].contiguous(), y,
            torch.ones((Cg // G,), device=dev), G)
        nb, B = prob.valid.shape
        on = torch.zeros((nb, B // G), device=dev)
        for b in range(12):
            on[b, torch.randperm(B // G, generator=gen, device=dev)[:3]] = 1
        beta = 0.05 * torch.randn((nb, B), generator=gen, device=dev) * \
            on.repeat_interleave(G, dim=1)
        st = group_cd._group_init(prob, beta.contiguous(), None)
        c = group_cd._full_sweep(prob, prob.y, False).reshape(nb, -1, G)
        lam = 0.2 * float(torch.linalg.vector_norm(c, dim=2).max()) / n
        coefs = fista_momentum(16, torch.float32)
        order = torch.arange(nb, device=dev)
        out["GP"] = _ms(lambda: gp.fused_group_pass(
            prob, st.beta, st.r, st.active, lam, float(n), order, coefs), 50)
        out["GP_active"] = int(st.active.sum())
        del prob, st, c
    if uf is not None:
        gu = torch.Generator(device=dev).manual_seed(18)
        ku, Cu = 98, 1024
        Xu = X[:, :Cu].contiguous()
        Ru = torch.randn((ku, n), generator=gu, device=dev)
        csu = Ru @ Xu
        Bsu = torch.randn((ku, Cu), generator=gu, device=dev) * (
            torch.rand((ku, Cu), generator=gu, device=dev) < 0.05)
        thru = torch.quantile(csu.abs(), 0.9, dim=1, keepdim=True) * (
            0.5 + torch.rand((ku, Cu), generator=gu, device=dev))
        certu = torch.arange(ku, device=dev) % 8 == 7
        uargs = (Xu.T @ Xu, thru, Bsu, csu, certu)
        out["UF"] = _ms(lambda: uf.fused_union_fista(*uargs, opts), 20)
        del Xu, Ru, uargs
    torch.cuda.empty_cache()
    return out


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


def small_main():
    """The ``--small`` keys (module docstring)."""
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA GPU", file=sys.stderr)
        sys.exit(1)
    import inspect

    import coordinatedescent_jl_tpu_torch as tcd
    from coordinatedescent_jl_tpu_torch.kernels import _build
    from coordinatedescent_jl_tpu_torch.kernels import active_pass as ap
    from coordinatedescent_jl_tpu_torch.kernels import check
    from coordinatedescent_jl_tpu_torch.kernels import gradient_sweep as gs
    from coordinatedescent_jl_tpu_torch.ops import block_cd
    from coordinatedescent_jl_tpu_torch.profile_paths import (
        bench_problem, vc_bench_problem)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"package": tcd.__file__}
    routes = "plan" in inspect.signature(ap.fused_active_pass).parameters
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

    def k1(inner, iters=16, **kw):
        return lambda: ap.fused_active_pass(*args, kind="wls", inner=inner,
                                            iters=iters, rsqr=st.rsqr, **kw)

    out["K1p"] = _ms(k1("ista"), 200)
    out["K1p_iters0"] = _ms(k1("ista", 0), 200)
    out["K1p_exact"] = _ms(k1("exact"), 200)
    out["K1p_exact_scan_dev_ms"] = (out["K1p_exact"]["dev_ms_per_kernel"]
                                    - out["K1p_iters0"]["dev_ms_per_kernel"])
    out["K5p"] = _ms(lambda: gs.fused_gradient_sweep(prob.Xwb, st.r), 200)
    out["K5p_matmul"] = _ms(lambda: torch.matmul(st.r, prob.Xwb), 200)
    sms = _build.sm_count(dev)
    if routes:
        plan = ap.plan_active_pass(nv, B, 4, sms, _build.smem_optin(dev))
        out["K1p_plan"] = plan._asdict()
        for inner in ("ista", "exact"):
            res = {}
            for name, cl in (("cluster", True), ("coop", False)):
                pl = ap.on_route(plan, cl, B, 4)
                out[f"K1p_{name}_{inner}"] = _ms(k1(inner, plan=pl), 200)
                res[name] = k1(inner, plan=pl)()
            out[f"K1p_{inner}_bitwise"] = all(
                torch.equal(a, c) for a, c in zip(res["cluster"],
                                                  res["coop"]))
        # K1′ (FISTA) at other CTA counts on each route
        for G in (4, 8, 16, 32):
            for name, cl in (("cluster", True), ("coop", False)):
                if cl and G > 16:
                    continue
                pl = ap.on_route(ap.ActivePlan(G, -(-nv // G), True, True, 0),
                                 cl, B, 4)
                out[f"K1p_{name}_G{G}"] = _ms(k1("ista", plan=pl), 200)
        ref = None
        for S in range(1, 17):
            rows = -(-nv // S)
            if -(-nv // rows) != S:
                continue
            pl = gs.SweepPlan(1, S, rows, S, S > 1)
            key = f"K5p_S{S}"
            out[key] = _ms(lambda: gs.fused_gradient_sweep(
                prob.Xwb, st.r, plan=pl), 200)
            if S == 3:
                ref = gs.fused_gradient_sweep(prob.Xwb, st.r, plan=pl)
        pl = gs.SweepPlan(1, 3, 167, 3, False)
        out["K5p_S3_two"] = _ms(lambda: gs.fused_gradient_sweep(
            prob.Xwb, st.r, plan=pl), 200)
        out["K5p_S3_bitwise"] = torch.equal(
            ref, gs.fused_gradient_sweep(prob.Xwb, st.r, plan=pl))
        # where the cluster regime ends: 8 blocks with cached Grams at n =
        # 1,000, 2,000 and 4,096 (ls, FISTA) on a 16-CTA cluster against the
        # cooperative route's own plan (one CTA an SM, 32 rows or more)
        g2 = torch.Generator(device=dev).manual_seed(3)
        for nn in (1000, 2000, 4096):
            pn = block_cd.build_blocked(
                "ls", tcd.CDOptions(block_size=B, cache_gram=True,
                                    compact=False),
                torch.ones(8 * B, device=dev),
                X=torch.randn((nn, 8 * B), generator=g2, device=dev),
                y=torch.randn((nn,), generator=g2, device=dev))
            sn = block_cd._init_state("ls", pn, torch.zeros(
                (8, B), device=dev), None)
            an = (pn, sn.beta, sn.r, torch.ones(8, dtype=torch.bool,
                                                device=dev), 0.05, float(nn),
                  torch.arange(8, device=dev), torch.arange(B, device=dev))
            grid, rows = ap._rows(nn, sms)
            coop = ap.ActivePlan(grid, rows, True, True, ap._smem(
                B, 4, grid, rows, True, True, False, True), False)
            clus = ap.on_route(ap.ActivePlan(*ap._rows(nn, 16), True, True, 0),
                               True, B, 4)
            for name, pl in (("cluster", clus), ("coop", coop)):
                out[f"K1n{nn}_{name}"] = _ms(lambda: ap.fused_active_pass(
                    *an, inner="ista", iters=16, plan=pl), 100)
                out[f"K1n{nn}_{name}"]["plan"] = pl._asdict()
            del pn, sn, an
    out.update(_check_small(check, block_cd, prob, st, vp.lam0, nv, dev))
    lib = _build.library()
    if getattr(lib, "cdt_check_probe", None) is not None:
        stream = _build.stream(dev)
        out["probe_cta"] = _ms(lambda: _build.check(
            lib.cdt_check_probe(stream), "check_probe"), 200)
    if getattr(lib, "cdt_probe_launch", None) is not None and routes:
        stream = _build.stream(dev)
        gram = prob.Kb                   # 64 KB, read by every CTA
        for name, cl in (("coop", 0), ("cluster", 1)):
            pl = ap.on_route(plan, bool(cl), B, 4)
            for nbar, nbytes in ((0, 0), (1, 0), (2, 0), (1, gram.numel() * 4)):
                key = f"probe_{name}_b{nbar}" + ("_gram" if nbytes else "")
                out[key] = _ms(lambda: _build.check(lib.cdt_probe_launch(
                    cl, pl.grid, pl.smem, nbar, gram.data_ptr(), nbytes,
                    stream), "probe"), 200)
    del prob, st, args

    bp = bench_problem(dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(1)
    cols = torch.unique(torch.cat([bp.support, torch.randperm(
        bp.X.shape[1], generator=g, device=dev)[:1024]]))[:1024]
    n = bp.X.shape[0]
    ws = block_cd.build_blocked("ls", bp.opts.replace(cache_gram=True),
                                torch.ones(1024, device=dev),
                                X=bp.X[:, cols].contiguous(), y=bp.y)
    del bp
    r = torch.randn(n, generator=g, device=dev)
    out["K5ws"] = _ms(lambda: gs.fused_gradient_sweep(ws.Xwb, r), 200)
    out["K5ws_matmul"] = _ms(lambda: torch.matmul(r, ws.Xwb), 200)
    if routes:
        pl = gs.SweepPlan(8, 16, -(-n // 16), 128, True)
        out["K5ws_S16"] = _ms(lambda: gs.fused_gradient_sweep(
            ws.Xwb, r, plan=pl), 200)
    print(json.dumps(out), flush=True)


def _check_small(check, block_cd, prob, st, lam0, nv, dev) -> dict:
    """K3/K4 at the varying-coefficient point (``K3_vc`` screen off as
    the scan runs it, ``K3_vc_screen`` on, ``K4_vc``) and at 8 rows (the
    point's block repeated: ``K3_nb8``, ``K3_nb8_screen``, ``K4_nb8``),
    each on the route the tree plans; where the tree has the one-CTA route
    (``CheckPlan.cta``) also the cooperative route forced at one CTA
    (``_coop``), and each with ``bitwise``: its outputs equal the
    cooperative route's."""
    B = prob.lamw.shape[1]
    c = block_cd._full_gradient_c("wls", prob, st.r, kernels=False)
    scal = block_cd._check_scalars(lam0, float(nv), torch.dot(st.r, st.r),
                                   torch.zeros((), device=dev), 1e-7)
    one = (c, st.beta, torch.full((1,), 1e-3, device=dev), prob.adiag,
           prob.lamw, prob.valid.float(), prob.xwnorm)
    routes = hasattr(check.CheckPlan, "cta")
    out = {}
    for tag, nb in (("vc", 1), ("nb8", 8)):
        a = tuple(torch.cat([t] * nb).contiguous() for t in one) + (scal,)
        _, ub, cand, bound, _, _ = check.check_phase_a(*a, screen=False)
        b = (a[0], a[1], bound, ub, cand, *a[3:])
        plans = {"": {}}
        if routes:
            plans["_coop"] = {
                "a": check._plan(False, nb, B, dev.index)._replace(coop=True),
                "b": check._plan(True, nb, B, dev.index)._replace(coop=True)}
        got = {}
        for key, pl in plans.items():
            kw_a = {"plan": pl["a"]} if pl else {}
            kw_b = {"plan": pl["b"]} if pl else {}
            for name, fn in (
                    (f"K3_{tag}", lambda: check.check_phase_a(
                        *a, screen=False, **kw_a)),
                    (f"K3_{tag}_screen", lambda: check.check_phase_a(
                        *a, screen=True, **kw_a)),
                    (f"K4_{tag}", lambda: check.check_phase_b(*b, **kw_b))):
                out[name + key] = _ms(fn, 200)
                got[name, key] = fn()
        for (name, key), outs in got.items():
            if (name, "_coop") in got:
                out[name + key]["bitwise"] = all(
                    torch.equal(x, y)
                    for x, y in zip(outs, got[name, "_coop"]))
    return out


def stamps_main():
    """``--stamps``: K1′'s first visit by phase, in SM clock cycles, on
    each route at 16 and 8 CTAs (FISTA and ``iters = 0``), from a build
    with ``-DCDT_AP_STAMPS`` (thread 0 of each CTA stamps ``clock64()``):
    setup (kernel start to the loop), sweep (to the barrier), barrier,
    gather (the partial c's summed, the solve's vectors set), solve,
    residual (the update and the next visit's search), tail (the loop's
    end to the kernel's), each the mean over the CTAs of 100 calls."""
    import os

    os.environ["CDT_NVCC_FLAGS"] = "-DCDT_AP_STAMPS"
    import ctypes

    import numpy as np

    import coordinatedescent_jl_tpu_torch as tcd
    from coordinatedescent_jl_tpu_torch.kernels import _build
    from coordinatedescent_jl_tpu_torch.kernels import active_pass as ap
    from coordinatedescent_jl_tpu_torch.ops import block_cd
    from coordinatedescent_jl_tpu_torch.profile_paths import vc_bench_problem

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    vp = vc_bench_problem(dev)
    B, nv = 128, vp.X.shape[0]
    w = tcd.evaluate(tcd.GaussianKernel(vp.h), vp.z, 0.5)
    eX = tcd.expand_X(vp.X, vp.z, 0.5, vp.degree)
    lamw = tcd.std_X(eX, w)
    prob = block_cd.build_blocked("wls", tcd.CDOptions(), lamw, X=eX,
                                  y=vp.y, w=w)
    st = block_cd._init_state("wls", prob, torch.zeros((1, B), device=dev),
                              None)
    args = (prob, st.beta, st.r, torch.ones(1, dtype=torch.bool, device=dev),
            vp.lam0, float(nv), torch.arange(1, device=dev),
            torch.arange(B, device=dev))
    lib = _build.library()
    buf = np.zeros((132, 8), dtype=np.int64)
    names = ("sweep", "barrier", "gather", "solve", "residual", "loop_end",
             "tail")
    out = {}
    for G in (16, 8):
        for cl in (True, False):
            pl = ap.on_route(ap.ActivePlan(G, -(-nv // G), True, True, 0),
                             cl, B, 4)
            for iters in (16, 0):
                rows = []
                for _ in range(101):
                    ap.fused_active_pass(*args, kind="wls", inner="ista",
                                         iters=iters, rsqr=st.rsqr, plan=pl)
                    torch.cuda.synchronize()
                    _build.check(lib.cdt_ap_stamps(
                        buf.ctypes.data_as(ctypes.c_void_p)), "stamps")
                    rows.append(np.diff(buf[:G], axis=1))
                d = np.stack(rows[1:]).astype(np.float64)   # (calls, G, 7)
                key = (f"{'cluster' if cl else 'coop'}_G{G}_iters{iters}")
                out[key] = {n: round(float(d[:, :, i].mean()), 1)
                            for i, n in enumerate(names)}
                out[key]["slowest_sweep"] = round(float(
                    d[:, :, 0].max(axis=1).mean()), 1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    if "--small" in sys.argv:
        small_main()
    elif "--stamps" in sys.argv:
        stamps_main()
    else:
        main()
