#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``coordinatedescent_jl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each failing loudly (exit code 1, no result line):

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: the hand-written kernels, from ``coordinatedescent_jl_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel);
3. each kernel against its plain PyTorch twin on the card, on the same
   inputs, at the main paths' shapes (n = 10,000, p = 100,000, B = 128),
   with the tolerance stated beside each comparison, the kernel's, the
   twin's and (where one exists) the library call's times, and the
   kernel's bound: K1 in float32 on the scan's working set (8 active
   blocks, and 1) and the full problem, and in float64 on the polish's
   inner-solve blocks, with a check that one K1 call launches one device
   kernel and reads nothing to the host; K5 on the working set's 8 blocks
   and on the full design; then the K2/K5 crossover of the gradient
   refresh; K3 (screen on and off) and K4 on a mid-solve state, with
   exact masks, one device kernel and no host read per call;
4. the main paths on the bench problem (dense Gaussian X, n = 10,000,
   p = 100,000, scattered s = 100 support, f32), each run with the launch
   counts set to 0 just before it and read just after:
   a. the scan: ``lasso`` at 0.05·λmax and the 100-point ``lasso_path``
      from 0.5·λmax to 0.05·λmax (``path_batch=0``), with the kernels and
      with the plain path (``use_pallas=False``); the final point's
      relative duality gap (float64 accumulation) must be <= 1e-5 and the
      plain solves must reach the same support;
   b. the batched path (``path_batch=128, coarse_stride=99``, bench.py's
      headline configuration): it must certify without falling back, every
      point must agree in support with the scan of 4a, and the plain run
      with it;
   c. the time to the 1e-7 gap: a warm ``lasso`` at 0.05·λmax (default
      options, as bench.py) then ``polish_lasso`` of its solution, which
      must converge to a relative gap <= 1e-7; the two are counted apart,
      and the polish alone must launch K1's and K5's float64 forms.
   Every kernel must have launched in the runs that drive it.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA GPU; exits 1 without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

# the H100 SXM's published rates (NVIDIA's data sheet, dense, 700 W):
# device memory, and the non-tensor-core float32 / float64 peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    fn()                                        # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn):
    """(result, seconds) of ``fn`` with the card synchronised at both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def one_call(fn):
    """(host reads, device kernels' names, device ms) of one call of
    ``fn`` under torch.profiler (``fn`` warmed up first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from coordinatedescent_jl_tpu_torch.utils import host

    fn()
    torch.cuda.synchronize()
    host.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return (host.COUNTS["host_reads"], [e.name for e in kern],
            sum(e.time_range.elapsed_us() for e in kern) * 1e-3)


def maxdiff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bound_ms(nbytes: float, flops: float, peak: str):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / PEAK_FLOPS[peak] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def support_mismatch(a, b, tol):
    """Coordinates whose support differs between ``a`` and ``b`` while one
    of them is above ``tol`` in magnitude."""
    import torch

    differ = (a != 0) != (b != 0)
    return int((differ & (torch.maximum(a.abs(), b.abs()) > tol)).sum())


def main():
    try:
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    try:
        import coordinatedescent_jl_tpu_torch as tcd
        from coordinatedescent_jl_tpu_torch.kernels import (_build,
                                                            active_pass,
                                                            check,
                                                            gradient_sweep)
        from coordinatedescent_jl_tpu_torch.models import polish as pol
        from coordinatedescent_jl_tpu_torch.ops import block_cd
        from coordinatedescent_jl_tpu_torch.profile_paths import bench_problem
        from coordinatedescent_jl_tpu_torch.utils import host
    except ImportError as e:
        fail(f"the port's package is not importable here: {e}")
    gs = gradient_sweep

    # ---- 1. environment -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    try:
        _build.library()
    except RuntimeError as e:
        fail(f"kernel build failed: {e}")
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), file=sys.stderr)

    # ---- data: the bench problem (bench.py:164-183, same construction) ---
    bp = bench_problem(dev, seed=0)
    X, y, support, beta_true = bp.X, bp.y, bp.support, bp.beta_true
    lammax, lams, opts = bp.lammax, bp.lams, bp.opts
    (n, p), s, L = X.shape, support.numel(), len(lams)
    g = torch.Generator(device=dev).manual_seed(1)
    log(f"data: n={n} p={p} s={s} lammax={lammax:.6f}")

    # ---- 3. kernels against their plain twins ---------------------------
    rec = {}
    ok = True

    def report(key, name, err, tol, ms, plain_ms, what, nbytes, flops,
               peak="f32", library_ms=None):
        nonlocal ok
        good = err <= tol
        ok = ok and good
        bms, by = bound_ms(nbytes, flops, peak)
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        log(f"{name} [{what}]: max_abs_err {err:.3e} (tol {tol:.1e}) "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, bound "
            f"{bms:.4f} ms ({by}) {'ok' if good else 'MISMATCH'}")
        if key:
            rec[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by, library_ms=library_ms)

    B = 128
    f4 = 4
    ws_opts = opts.replace(cache_gram=True)
    nb_full = -(-p // B)
    # K1 on the working-set shape: 8 blocks of (n, 128) with cached Grams,
    # a state from the planted support (scaled), lam0 = 0.05 lammax
    cols = torch.unique(torch.cat([support, torch.randperm(
        p, generator=g, device=dev)[:1024]]))[:1024]
    ws = block_cd.build_blocked("ls", ws_opts, torch.ones(1024, device=dev),
                                X=X[:, cols].contiguous(), y=y)
    bws = (0.9 * beta_true[cols]).reshape(8, B).contiguous()
    st = block_cd._init_state("ls", ws, bws, None)
    lam0 = 0.05 * lammax
    border8 = torch.arange(8, device=dev)
    corder = torch.arange(B, device=dev)
    act8 = torch.ones(8, dtype=torch.bool, device=dev)
    # bytes: the 8 blocks, their Grams, lamw, beta and r in and out;
    # flops: c and the residual update (2 n B each) and 16 FISTA steps
    # (2 B^2 each) per block
    k1_bytes = f4 * (8 * n * B + 8 * B * B + 8 * B + 2 * 8 * B + 2 * n)
    k1_flops = 8 * (4 * n * B + 16 * 2 * B * B)
    # beta moves by ~1e-6 relative per coordinate from f32 summation order
    # (c sums n = 10K products); r by ~1e-5 absolute over |r| ~ 1e2
    for inner in ("ista", "exact"):
        args = (ws, st.beta, st.r, act8, lam0, float(n), border8, corder)
        kw = dict(kind="ls", inner=inner, iters=16)
        bk, rk, mk, _ = active_pass.fused_active_pass(*args, **kw)
        bp, rp, mp, _ = active_pass.fused_active_pass_plain(*args, **kw)
        err = max(maxdiff(bk, bp), maxdiff(mk, mp))
        errr = maxdiff(rk, rp)
        ms = cuda_ms(lambda: active_pass.fused_active_pass(*args, **kw), 20)
        pms = cuda_ms(lambda: active_pass.fused_active_pass_plain(*args, **kw),
                      3 if inner == "exact" else 10)
        report("K1" if inner == "ista" else None, "K1 fused_active_pass",
               err, 1e-4, ms, pms, f"8 blocks, Gram on, {inner}; r err "
               f"{errr:.2e}", k1_bytes, k1_flops)
        ok = ok and errr <= 1e-3
    # one active block of the 8, as most of the scan's passes visit
    act1 = border8 == 3
    args = (ws, st.beta, st.r, act1, lam0, float(n), border8, corder)
    kw = dict(kind="ls", inner="ista", iters=16, rsqr=st.rsqr)
    bk, rk, mk, _ = active_pass.fused_active_pass(*args, **kw)
    bp, rp, mp, _ = active_pass.fused_active_pass_plain(*args, **kw)
    err = max(maxdiff(bk, bp), maxdiff(mk, mp))
    errr = maxdiff(rk, rp)
    ms = cuda_ms(lambda: active_pass.fused_active_pass(*args, **kw), 20)
    pms = cuda_ms(lambda: active_pass.fused_active_pass_plain(*args, **kw), 10)
    report(None, "K1 fused_active_pass", err, 1e-4, ms, pms,
           f"1 of 8 blocks, Gram on, ista; r err {errr:.2e}",
           f4 * (n * B + B * B + 8 * B + 2 * 8 * B + 2 * n),
           4 * n * B + 16 * 2 * B * B)
    ok = ok and errr <= 1e-3
    # one call on the card: no host read, one device kernel
    reads, names, dms = one_call(lambda: active_pass.fused_active_pass(
        ws, st.beta, st.r, act8, lam0, float(n), border8, corder, **kw))
    log(f"K1 one call: host reads {reads}, device kernels {len(names)} "
        f"{sorted(set(names))}, device {dms:.4f} ms")
    if reads or len(names) != 1:
        fail("fused_active_pass must launch one kernel and read nothing to "
             "the host")

    # K5 on the working set's (8, n, 128) refresh: the planner splits the
    # rows of its 8 column tiles; same tolerance as the full sweep below
    ck = gs.fused_gradient_sweep(ws.Xwb, st.r)
    cp = gs.fused_gradient_sweep_plain(ws.Xwb, st.r)
    plan = gs.plan_dense_sweep(8, n, B, _build.sm_count(dev))
    ms = cuda_ms(lambda: gs.fused_gradient_sweep(ws.Xwb, st.r), 50)
    pms = cuda_ms(lambda: gs.fused_gradient_sweep_plain(ws.Xwb, st.r), 50)
    lms = cuda_ms(lambda: torch.matmul(st.r, ws.Xwb), 50)
    report(None, "K5 fused_gradient_sweep", maxdiff(ck, cp),
           1e-5 * float(cp.abs().max()), ms, pms,
           f"8-block working set, split {plan.split} x {plan.rows} rows",
           f4 * (8 * n * B + n + 8 * B), 2 * 8 * n * B, library_ms=lms)
    del ws, st

    # K1, float64 with the exact inner and cached Grams: the polish's inner
    # solve on its own inputs (_restricted_problem), the working set of a
    # lasso at 0.05 lammax (default options, as 4c) padded to the polish's
    # allocation.  Both sides add n = 10K f64 products in other orders:
    # 1e-11 of max(1, max|beta|) for beta and maxh, 1e-11 of max|r| for r
    sol0 = tcd.lasso(X, y, lam0)
    sup0 = torch.nonzero(sol0.x).flatten()
    ns0 = sup0.numel()
    C0 = pol._allocation(ns0, p, 4096)
    idx0 = torch.full((C0,), p, dtype=torch.int64, device=dev)
    idx0[:ns0] = sup0
    beta00 = torch.zeros((C0,), dtype=torch.float64, device=dev)
    beta00[:ns0] = sol0.x[sup0].double()
    prob64, st64, _ = pol._restricted_problem(
        X, y.double(), torch.ones(p, dtype=torch.float64, device=dev), idx0,
        beta00)
    nb64 = prob64.lamw.shape[0]
    args = (prob64, st64.beta, st64.r, st64.active, lam0, float(n),
            torch.arange(nb64, device=dev), corder)
    kw = dict(kind="ls", inner="exact")
    bk, rk, mk, _ = active_pass.fused_active_pass(*args, **kw)
    bp64, rp, mp, _ = active_pass.fused_active_pass_plain(*args, **kw)
    err = max(maxdiff(bk, bp64), maxdiff(mk, mp))
    errr = maxdiff(rk, rp)
    ms = cuda_ms(lambda: active_pass.fused_active_pass(*args, **kw), 20)
    pms = cuda_ms(lambda: active_pass.fused_active_pass_plain(*args, **kw), 3)
    report("K1f64", "K1 fused_active_pass", err,
           1e-11 * max(1.0, float(bp64.abs().max())), ms, pms,
           f"float64, the polish's {nb64} block(s) of support {ns0}, Gram "
           f"on, exact; r err {errr:.2e}",
           8 * (nb64 * n * B + nb64 * B * B + 4 * nb64 * B + 2 * n),
           nb64 * (4 * n * B + 2 * B * B), peak="f64")
    ok = ok and errr <= 1e-11 * float(rp.abs().max())
    del prob64, st64, args, sol0

    # K1 on the full 782-block problem (4.0 GB blocked copy), Gram off:
    # the fallback active pass over the planted support's blocks
    full = block_cd.build_blocked("ls", opts, torch.ones(p, device=dev), X=X,
                                  y=y)
    if full.Kb is not None:
        fail("the full problem must not cache Grams (compaction is on)")
    bfull = block_cd._to_blocked_beta(0.9 * beta_true, B).contiguous()
    st = block_cd._init_state("ls", full, bfull, None)
    border = torch.arange(nb_full, device=dev)
    na = int(st.active.sum())
    args = (full, st.beta, st.r, st.active, lam0, float(n), border, corder)
    kw = dict(kind="ls", inner="ista", iters=16)
    bk, rk, mk, _ = active_pass.fused_active_pass(*args, **kw)
    bp, rp, mp, _ = active_pass.fused_active_pass_plain(*args, **kw)
    err = max(maxdiff(bk, bp), maxdiff(mk, mp))
    ms = cuda_ms(lambda: active_pass.fused_active_pass(*args, **kw), 3)
    pms = cuda_ms(lambda: active_pass.fused_active_pass_plain(*args, **kw), 3)
    report(None, "K1 fused_active_pass", err, 1e-4, ms, pms,
           f"{na} of {nb_full} blocks active, Gram off, ista; r err "
           f"{maxdiff(rk, rp):.2e}",
           f4 * (na * n * B + 3 * nb_full * B + 2 * n),
           na * (4 * n * B + 2 * n * B * B + 16 * 2 * B * B))
    ok = ok and maxdiff(rk, rp) <= 1e-3

    # K2 with ~30% of the blocks needed; c sums n = 10K products in another
    # order than the plain product: relative 1e-5 of max|c|
    need = torch.rand(nb_full, generator=g, device=dev) < 0.3
    c_prev = torch.randn((nb_full, B), generator=g, device=dev)
    nn = int(need.sum())
    ck = gs.restricted_gradient_sweep(full.Xwb, st.r, need, c_prev)
    cp = gs.restricted_gradient_sweep_plain(full.Xwb, st.r, need, c_prev)
    err = maxdiff(ck, cp)
    tol = 1e-5 * float(cp.abs().max())
    ms = cuda_ms(lambda: gs.restricted_gradient_sweep(
        full.Xwb, st.r, need, c_prev), 10)
    pms = cuda_ms(lambda: gs.restricted_gradient_sweep_plain(
        full.Xwb, st.r, need, c_prev), 10)
    report("K2", "K2 restricted_gradient_sweep", err, tol, ms, pms,
           f"{nn} of {nb_full} blocks",
           f4 * (nn * n * B + n + 2 * nb_full * B) + nb_full,
           2 * nn * n * B)

    # K5, blocked: every block, the same tolerance as K2; the plain twin is
    # the library call (one batched cuBLAS GEMV), timed again as such
    ck = gs.fused_gradient_sweep(full.Xwb, st.r)
    cp = gs.fused_gradient_sweep_plain(full.Xwb, st.r)
    err = maxdiff(ck, cp)
    tol = 1e-5 * float(cp.abs().max())
    ms = cuda_ms(lambda: gs.fused_gradient_sweep(full.Xwb, st.r), 10)
    pms = cuda_ms(lambda: gs.fused_gradient_sweep_plain(full.Xwb, st.r), 10)
    lms = cuda_ms(lambda: torch.matmul(st.r, full.Xwb), 10)
    split = gs.plan_dense_sweep(nb_full, n, B, _build.sm_count(dev)).split
    report("K5", "K5 fused_gradient_sweep", err, tol, ms, pms,
           f"all {nb_full} blocks, split {split}",
           f4 * (nb_full * n * B + n + nb_full * B),
           2 * nb_full * n * B, library_ms=lms)

    # K2/K5 crossover of the gradient refresh (_refresh_c): the restricted
    # sweep at a fraction of the blocks against the dense branch (K5 and
    # the merge with the cached c)
    dense_ms = cuda_ms(lambda: torch.where(
        need[:, None], gs.fused_gradient_sweep(full.Xwb, st.r), c_prev), 10)
    cross = None
    rows = []
    for frac in (0.5, 0.6, 0.7, 0.8, 0.85, 0.9, 0.95, 1.0):
        nf = int(round(frac * nb_full))
        needf = torch.randperm(nb_full, generator=g, device=dev) < nf
        kms = cuda_ms(lambda: gs.restricted_gradient_sweep(
            full.Xwb, st.r, needf, c_prev, n_need=nf), 10)
        rows.append(f"{frac:.2f}: K2 {kms:.4f} ms")
        if cross is None and kms >= dense_ms:
            cross = frac
    log(f"refresh crossover: dense branch (K5 + merge) {dense_ms:.4f} ms; "
        + "; ".join(rows) + f"; K2 first >= dense at {cross} "
        f"(the engine takes the dense branch only at 1.00)")

    # K3/K4 on a mid-solve state: fresh c, a drift on half of the blocks.
    # The kernels round each elementwise operation as PyTorch does; only
    # the L1 sum of the screen (phase A, screen on) adds in another order,
    # so masks must agree exactly and values to relative 1e-5
    c_full = block_cd._full_gradient_c("ls", full, st.r, kernels=False)
    drift = torch.where(torch.rand(nb_full, generator=g, device=dev) < 0.5,
                        torch.rand(nb_full, generator=g, device=dev) * 1e-3,
                        torch.zeros(nb_full, device=dev))
    rn2 = torch.dot(st.r, st.r)
    scal = block_cd._check_scalars(lam0, float(n), rn2, torch.dot(st.r, y),
                                   1e-6)
    validf = full.valid.float()
    a_args = (c_full, st.beta, drift, full.adiag, full.lamw, validf,
              full.xwnorm, scal)
    # bytes: six (nb, B) inputs and the bound out, the per-block rows;
    # about 40 elementwise operations per coordinate
    for screen in (True, False):
        outk = check.check_phase_a(*a_args, screen=screen)
        outp = check.check_phase_a_plain(*a_args, screen=screen)
        masks = sum(int((outk[i] != outp[i]).sum()) for i in (0, 1, 2, 5))
        err = max(maxdiff(outk[3], outp[3]), maxdiff(outk[4], outp[4]))
        tol = 1e-5 * max(1.0, float(outp[3].abs().max()))
        ms = cuda_ms(lambda: check.check_phase_a(*a_args, screen=screen), 50)
        pms = cuda_ms(lambda: check.check_phase_a_plain(*a_args,
                                                        screen=screen), 20)
        reads, names, dms = one_call(
            lambda: check.check_phase_a(*a_args, screen=screen))
        report("K3" if screen else None, "K3 check_phase_a", err, tol, ms,
               pms, f"screen={screen}; mask mismatches {masks}; "
               f"need {int(outp[0].sum())}; one call: device {dms:.4f} ms, "
               f"{len(names)} kernel(s), {reads} host reads",
               f4 * (7 * nb_full * B + 5 * nb_full + 5), 40 * nb_full * B)
        ok = ok and masks == 0
        if reads or len(names) != 1:
            fail("check_phase_a must launch one kernel and read nothing to "
                 "the host")
        if screen:
            need_a, ub_a, cand_a, bound_a = outp[0], outp[1], outp[2], outp[3]
    b_args = (c_full, st.beta, bound_a, ub_a, cand_a, full.adiag, full.lamw,
              validf, full.xwnorm, scal)
    outk = check.check_phase_b(*b_args)
    outp = check.check_phase_b_plain(*b_args)
    masks = int((outk[1] != outp[1]).sum())
    err = maxdiff(outk[0], outp[0])
    ms = cuda_ms(lambda: check.check_phase_b(*b_args), 50)
    pms = cuda_ms(lambda: check.check_phase_b_plain(*b_args), 20)
    reads, names, dms = one_call(lambda: check.check_phase_b(*b_args))
    report("K4", "K4 check_phase_b", err, 1e-5 * max(1.0, float(outp[0])),
           ms, pms, f"mask mismatches {masks}; one call: device {dms:.4f} "
           f"ms, {len(names)} kernel(s), {reads} host reads",
           f4 * (7 * nb_full * B + 3 * nb_full + 5), 20 * nb_full * B)
    ok = ok and masks == 0
    if reads or len(names) != 1:
        fail("check_phase_b must launch one kernel and read nothing to the "
             "host")
    del full, st, args, a_args, b_args, c_full, bk, rk, bp, rp, ck, cp
    torch.cuda.empty_cache()

    # K5, float64-accumulating, on the dense design: a float64 residual of
    # the planted β against the twin that widens column chunks to f64;
    # both sum n = 10K f64 products in other orders: 1e-10 of max|g|
    r64 = y.double() - X[:, support].double() @ beta_true[support].double()
    gk = gs.grad_f64(X, r64)
    gp = gs.grad_f64_plain(X, r64)
    err = maxdiff(gk, gp)
    tol = 1e-10 * float(gp.abs().max())
    ms = cuda_ms(lambda: gs.grad_f64(X, r64), 10)
    pms = cuda_ms(lambda: gs.grad_f64_plain(X, r64), 3)
    report("K5f64", "K5 grad_f64", err, tol, ms, pms,
           f"dense ({n}, {p}) f32, f64 r and accumulation",
           f4 * n * p + 8 * n + 8 * p, 2 * n * p, peak="f64")
    del gk, gp, r64
    torch.cuda.empty_cache()
    if not ok:
        fail("a kernel disagrees with its plain twin")

    # ---- 4. the main paths ----------------------------------------------
    def counts():
        return {"K1": active_pass.LAUNCHES,
                "K1f64": active_pass.LAUNCHES_F64, "K2": gs.LAUNCHES,
                "K3": check.LAUNCHES_A, "K4": check.LAUNCHES_B,
                "K5": gs.LAUNCHES_DENSE, "K5f64": gs.LAUNCHES_F64}

    def reset_counts():
        active_pass.LAUNCHES = active_pass.LAUNCHES_F64 = gs.LAUNCHES = 0
        check.LAUNCHES_A = check.LAUNCHES_B = 0
        gs.LAUNCHES_DENSE = gs.LAUNCHES_F64 = 0
        host.reset()

    def require_launches(path, launches, keys):
        missing = [k for k in keys if launches[k] == 0]
        if missing:
            fail(f"kernels not launched by the {path} run: {missing}")

    total = dict.fromkeys(counts(), 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # 4a. the scan
    reset_counts()
    lam_end = float(lams[-1])
    sol, t_solve = wall(lambda: tcd.lasso(X, y, lam_end, options=opts))
    reads_solve = dict(host.COUNTS)
    path, t_path = wall(lambda: tcd.lasso_path(
        X, y, lams, options=opts, standardize_X=False, path_batch=0))
    launches = counts()
    reads = dict(host.COUNTS)
    log(f"main path (kernels): lasso {t_solve:.3f} s, lasso_path "
        f"({L} points) {t_path:.3f} s; launches {launches}")
    log(f"host reads: lasso {reads_solve['host_reads']} over "
        f"{reads_solve['epochs']} epochs; lasso + path {reads['host_reads']} "
        f"over {reads['epochs']} epochs "
        f"({reads['host_reads'] / max(reads['epochs'], 1):.2f} per epoch)")
    require_launches("scan", launches, ("K1", "K2", "K3", "K4", "K5"))
    add(launches)
    if tuple(path.beta_path.shape) != (L, p):
        fail(f"path shape {tuple(path.beta_path.shape)} != {(L, p)}")
    if not bool(torch.isfinite(path.beta_path).all()):
        fail("non-finite coefficients on the path")
    gap, primal = tcd.lasso_duality_gap_f64(X, y, path.beta_path[-1], lam_end)
    gap1, primal1 = tcd.lasso_duality_gap_f64(X, y, sol.x, lam_end)
    rel, rel1 = gap / primal, gap1 / primal1
    nnz = int((path.beta_path[-1] != 0).sum())
    recovered = int((path.beta_path[-1][support] != 0).sum())
    log(f"final point: rel gap {rel:.3e}, nnz {nnz}, planted support "
        f"recovered {recovered}/{s}; lasso rel gap {rel1:.3e}")
    if not rel <= 1e-5 or not rel1 <= 1e-5:
        fail(f"relative duality gap above 1e-5: path {rel:.3e}, lasso {rel1:.3e}")

    plain = opts.replace(use_pallas=False)
    reset_counts()
    sol_p, t_solve_p = wall(lambda: tcd.lasso(X, y, lam_end, options=plain))
    path_p, t_path_p = wall(lambda: tcd.lasso_path(
        X, y, lams, options=plain, standardize_X=False, path_batch=0))
    if any(counts().values()):
        fail("use_pallas=False launched a kernel")
    log(f"main path (plain): lasso {t_solve_p:.3f} s, lasso_path "
        f"{t_path_p:.3f} s")
    # f32 solves at opt_tol 1e-6 may differ in coordinates this close to 0
    supp_tol = 1e-4
    for name, a, b in (("lasso", sol.x, sol_p.x),
                       ("path end", path.beta_path[-1], path_p.beta_path[-1])):
        bad = support_mismatch(a, b, supp_tol)
        log(f"{name}: kernel vs plain support: {int((a != 0).sum())} vs "
            f"{int((b != 0).sum())}, differing "
            f"{int(((a != 0) != (b != 0)).sum())} (above {supp_tol:g}: "
            f"{bad}), max |diff| {maxdiff(a, b):.3e}")
        if bad:
            fail(f"{name}: kernel and plain supports differ above {supp_tol:g}")
    del sol_p, path_p
    torch.cuda.empty_cache()

    # 4b. the batched path (bench.py:227-261): first call, then the warm
    # run whose launches are counted
    def batched(options):
        st = {}
        with warnings.catch_warnings(record=True) as wl:
            warnings.simplefilter("always")
            pb = tcd.lasso_path(X, y, lams, options=options,
                                standardize_X=False, path_batch=128,
                                coarse_stride=L - 1, stats=st)
        fell = [str(w.message) for w in wl
                if issubclass(w.category, RuntimeWarning)]
        if fell or not st.get("batched_certified"):
            fail(f"the batched path fell back to the scan: {st} {fell}")
        return pb, st

    (pb, st_b), t_first = wall(lambda: batched(opts))
    reset_counts()
    (pb, st_b), t_batched = wall(lambda: batched(opts))
    launches = counts()
    reads = dict(host.COUNTS)
    require_launches("batched path", launches, ("K1", "K3", "K4", "K5"))
    add(launches)
    bad = support_mismatch(pb.beta_path, path.beta_path, supp_tol)
    dmax = maxdiff(pb.beta_path, path.beta_path)
    log(f"batched path (kernels): first {t_first:.3f} s, warm "
        f"{t_batched:.3f} s; stall_escaped_lanes "
        f"{st_b['stall_escaped_lanes']}; launches {launches}; host reads "
        f"{reads['host_reads']} over {reads['epochs']} epochs; vs scan: "
        f"support differing above {supp_tol:g} {bad}, max |dbeta| "
        f"{dmax:.3e}")
    if tuple(pb.beta_path.shape) != (L, p) or bad:
        fail("the batched path disagrees with the scan in support")
    reset_counts()
    (pbp, _), t_batched_p = wall(lambda: batched(plain))
    if any(counts().values()):
        fail("use_pallas=False launched a kernel")
    bad = support_mismatch(pb.beta_path, pbp.beta_path, supp_tol)
    log(f"batched path (plain): {t_batched_p:.3f} s; kernels vs plain: "
        f"support differing above {supp_tol:g} {bad}, max |dbeta| "
        f"{maxdiff(pb.beta_path, pbp.beta_path):.3e}")
    if bad:
        fail("the batched path's kernel and plain runs differ in support")
    del pb, pbp, path
    torch.cuda.empty_cache()

    # 4c. time to the 1e-7 gap (bench.py:300-320): a warm single solve with
    # the default options, then the polish of its own output
    lam_t = lam_end * (1.0 + 2e-7)
    tcd.polish_lasso(X, y, tcd.lasso(X, y, lam_end * (1.0 + 1e-7)).x,
                     lam_end * (1.0 + 1e-7))               # warm-up
    reset_counts()
    sol_t, t_single = wall(lambda: tcd.lasso(X, y, lam_t))
    launches_s, reads_s = counts(), dict(host.COUNTS)
    require_launches("lasso", launches_s, ("K1", "K3", "K4", "K5"))
    add(launches_s)
    reset_counts()
    res, t_polish = wall(lambda: tcd.polish_lasso(X, y, sol_t.x, lam_t))
    launches, reads = counts(), dict(host.COUNTS)
    require_launches("polish", launches, ("K1f64", "K5f64"))
    add(launches)
    log(f"time_to_1e7_gap_s {t_single + t_polish:.4f} (solve {t_single:.4f} "
        f"s + polish {t_polish:.4f} s); polish rel gap {res.rel_gap:.3e}, "
        f"converged {res.converged}, rounds {res.rounds}, support "
        f"{res.support_size}; launches: lasso {launches_s}, polish "
        f"{launches}; host reads: lasso {reads_s['host_reads']}, polish "
        f"{reads['host_reads']}")
    if not (res.converged and res.rel_gap <= 1e-7):
        fail(f"polish did not reach rel gap 1e-7: {res.rel_gap:.3e}")
    gap_c, primal_c = tcd.lasso_duality_gap_compensated(X, y, res.beta, lam_t)
    log(f"polished point, compensated gap recomputed: rel "
        f"{gap_c / primal_c:.3e}")
    if not gap_c / primal_c <= 1.1e-7:
        fail("the recomputed compensated gap is above 1.1e-7")

    src = "coordinatedescent_jl_tpu_torch/csrc/"
    meta = {
        "K1": ("fused_active_pass", "active_pass.cu",
               "coordinatedescent_jl_tpu/ops/pallas_block.py:537"),
        "K1f64": ("fused_active_pass (float64, exact)", "active_pass.cu",
                  "coordinatedescent_jl_tpu/ops/pallas_block.py:537"),
        "K2": ("restricted_gradient_sweep", "gradient_sweep.cu",
               "coordinatedescent_jl_tpu/ops/pallas_block.py:752"),
        "K3": ("check_phase_a", "check.cu",
               "coordinatedescent_jl_tpu/ops/pallas_check.py:108"),
        "K4": ("check_phase_b", "check.cu",
               "coordinatedescent_jl_tpu/ops/pallas_check.py:149"),
        "K5": ("fused_gradient_sweep", "dense_sweep.cu",
               "coordinatedescent_jl_tpu/ops/pallas_block.py:657"),
        "K5f64": ("grad_f64", "dense_sweep.cu",
                  "coordinatedescent_jl_tpu/ops/pallas_block.py:657"),
    }
    log(f"launches over the main-path runs: {total}")
    kernels = [{"name": meta[k][0], "route": "cuda", "source": src + meta[k][1],
                "replaces": meta[k][2], "launches": total[k], **rec[k]}
               for k in meta]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
