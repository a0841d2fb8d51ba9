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
   kernel and reads nothing to the host; K1's wls form (float32, FISTA,
   Gram on and off, random positive row weights) and its sqrt form
   (float32 FISTA and exact on the working set, float64 exact on the sqrt
   polish's inner-solve blocks), β, r, maxh and the returned ``‖r‖²``
   against the twins; K5 on the working set's 8 blocks
   and on the full design; the loadings sweep LD (the feasible Lasso's
   ``Σ_i r_i² x_ij²``) on the full blocked design in float32 and, after K5's
   float64-accumulating form, on the dense design in float64, each one
   ``loadings_kernel`` a call with no host read; BL, the design's set-up
   copy (the padded blocked design and its columns' sums of squares, one
   launch), at 10,000 × 100,000 and, with the p = 1M rows below, at
   1,000 × 1,000,000 float32: the copy bit for bit the twin's, the sums
   within one ulp of the float64 sums, its device time beside its bound
   (8.0e9 B: 2.39 ms); then the K2/K5 crossover
   of the gradient refresh; K3 (screen on and off) and K4 on a mid-solve
   state, with exact masks, one device kernel and no host read per call,
   and again on
   8 of its blocks (the lasso's working set) on their plain one-CTA route,
   held as at one block below; then, at the
   varying-coefficient scan's shape (one grid point's wls problem of 4j:
   n = 500, one block of 128 columns, the JAX package's resident pass
   K1′), K1's wls form (FISTA and exact, cached Gram) on its cluster route
   and K5 on its cluster route (16 slices of one column tile, one cluster),
   each one kernel a call with no host read, and each held bit for bit
   against its previous route at the same plan (K1's cooperative grid of
   the same CTAs and rows, K5's two kernels at the same slices), each
   plan's clusters held at once (the card's occupancy query, at least
   one), then K3 with the screen off and K4 on their plain one-CTA route,
   each one kernel a call with no host read and held bit for bit against
   the cooperative route at one CTA, each with the device time of one call
   on both routes, and the device time of the library call beside K5 there
   and on the working set; last, at the p = 1M shapes of 4m (a
   single-device ``lasso`` at n = 1,000, p = 1,000,000, then a state at
   0.9 of its solution), K5 at (7,813, 1,000, 128), K3 (screen on and off)
   and K4 at 7,813 rows on the cooperative route, and K1 on its cluster
   route at n = 1,000 over the 8 blocks that hold most of the solve's
   support, each one call traced on the route its plan names;
4. the main paths on the bench problem (dense Gaussian X, n = 10,000,
   p = 100,000, scattered s = 100 support, f32), each run with the launch
   counts set to 0 just before it and read just after:
   a. the scan: ``lasso`` at 0.05·λmax and the 100-point ``lasso_path``
      from 0.5·λmax to 0.05·λmax (``path_batch=0``), with the kernels (its
      working sets' checks must launch K3 and K4 on the one-CTA route) and
      with the plain path (``use_pallas=False``); the final point's
      relative duality gap (float64 accumulation) must be <= 1e-5 and the
      plain solves must reach the same support; ``refit_lasso_path`` on
      the last 5 points' supports, held to its normal equations;
   b. the batched path (``path_batch=128, coarse_stride=99``, bench.py's
      headline configuration): it must certify without falling back, every
      point must agree in support with the scan of 4a, and the plain run
      with it; the kernel run launches the union-fista kernel once a
      refine round; then that kernel alone at the round's shape against
      its plain twin, with both times and its bound;
   c. the time to the 1e-7 gap: a warm ``lasso`` at 0.05·λmax (default
      options, as bench.py) then ``polish_lasso`` of its solution, which
      must converge to a relative gap <= 1e-7; the two are counted apart,
      and the polish alone must launch K1's and K5's float64 forms.
   d. ``sqrt_lasso`` at 1.1·sqrt(2 ln p) (bench.py's options), kernels and
      plain: same support, K1's sqrt form and K5 launched, K3/K4 never;
      ``sqrt_lasso_kkt_compensated`` of its solution; ``polish_sqrt_lasso``
      to a compensated relative KKT <= 1e-7 (K1 sqrt in float64, K5 f64);
   e. ``scaled_lasso`` at sqrt(2 ln p / n) then ``polish_scaled_lasso``:
      relative gap and relative σ change <= 1e-7;
   f. ``feasible_lasso`` at the same level then ``polish_feasible_lasso``:
      relative gap <= 1e-7, converged; each launches the loadings sweep;
   g. one ``coordinate_descent(WeightedLSLoss, ProxL1)`` solve with random
      row weights in [0.5, 1.5] at 0.05·λmax of the weighted problem,
      kernels and plain: same support; the run that launches K1's wls form
      and K3/K4 with the screen off.
   h. the group Lasso at bench.py's group shape (the bench design freed
      first): n = 10,000, p = 100,000, G = 8, 12 planted groups
      (``profile_paths.group_bench_problem``), ``group_lasso`` at
      0.3·group-λmax with ``opt_tol=1e-6, randomize=False``, kernels and
      plain: the same group support, no coordinate apart by more than
      1e-4, K5 and GP launched and no other kernel, GP once an active
      pass, the plain run launching nothing; one active pass at that
      shape from 0.9 x the solution, GP against its plain twin (the same
      groups, β and r within 1e-5 relative), both times and its bound;
      ``group_lasso_kkt_compensated`` of the solution;
      ``polish_group_lasso`` to a compensated per-group relative KKT
      <= 1e-7, converged, with K5's float64 form launched;
   i. ``symmetric_coordinate_descent`` at p = 128 (q = 8,256 packed
      coordinates): covariance thresholding through the packed
      ``QuadraticLoss``, held to its closed form (diagonal kept,
      soft(S, λ) off it) within 1e-5 in float32, exactly symmetric; the
      quad kind launches no kernel.
   j. the varying-coefficient suite at bench.py's configuration
      (``profile_paths.vc_bench_problem``: n = 500, p = 50, degree 1,
      ``GaussianKernel(0.1)``, λ0 = 0.05, a 1000-point grid, the default
      options): ``locpolyl1`` as the scan (first call, then the faster of
      2), which must launch K1's wls form, K3, K4 and K5 and never K2,
      with a plain run on the first 100 points in the same support; the
      batched grid (``grid_batch=128``), certified, in the scan's support,
      with finite refits, launching the vc-round kernel once a refine
      round; that kernel at the grid's shape (128 lanes, 16 steps, float32
      with X in shared memory and float64 from L2) against its plain twin
      (B within 1e-4 / 1e-10 of max |B|, the certificates' decisions
      equal), both times and its bound; ``locpoly`` (the faster of 2)
      held at three points to a float64 normal-equation solve within
      1e-4 relative;
      ``lvocv_locpolyl1`` batched over four bandwidths (the faster of 2)
      and sequential at h = 0.2, the two scores within 5e-2 relative.
   k. observability and persistence at full width, on the bench problem
      (before the design is freed for h): ``lasso_path_resumable`` over
      the 100 points with ``checkpoint_every=1`` (files under
      ``build/smoke_checkpoints``, removed afterwards), in 4a's supports,
      launching K1-K5, its time in ``save_checkpoint`` printed; an
      interrupted randomized run (50 points, ``checkpoint_every=10``)
      resumed to 100, bit for bit the uninterrupted run, final checkpoint
      fields included; ``solve_x_traffic`` at 4c's level (its nnz 4c's,
      at least one design read, below 1.05 x the measured peak) and one
      solve with and without ``count_x`` (the same β and launches, at most
      one more host read); ``solve_with_trace`` at the same level (4c's
      support; K1 its only kernel); ``measured_peak_hbm`` within 0.5-1.05
      of the data sheet; ``pass_roofline_multi`` at n = 10K, p = 100K,
      iters 16 and 1 (at most 1.05 of the measured peak);
      ``scaled_lasso_with_trace`` at 4e's level (σ within 1e-6 relative of
      4e's); inside h, ``group_solve_with_trace`` on h's problem (h's
      group support, K5 and GP launched, no other kernel); ``debug_nans`` at n = 2,000, p = 4,096
      (a NaN in r raises out of K5 and out of K1, a clean ``lasso``
      passes, the mode is off afterwards).
   l. the multi-device tiers (``parallel/``): (a) a world of one rank on
      NCCL (a ``HashStore``) on the bench problem: ``lasso_sharded`` at
      4c's level (4c's support, no coordinate 1e-4 from 4c's, relative gap
      <= 1e-5), ``lasso_path_sharded`` scan and batched (certified) in
      4a's supports, ``sqrt_lasso_sharded`` / ``scaled_lasso_sharded`` (σ
      within 1e-6 relative of 4e's) / ``feasible_lasso_sharded`` in 4d /
      4f's supports, ``lasso_sharded_with_trace`` in 4c's support,
      ``lasso_path_resumable_sharded`` over 20 points interrupted at 10 and
      resumed bit for bit; inside h, ``group_lasso_sharded`` with h's group
      support; each launches K1 (in its form) and K5, the f32 ls runs K3
      and K4, the group run K5 and GP only; (b) two Gloo ranks spawned on this
      card (time-sliced: no scaling), at p = 20,000: ``lasso_sharded``, a
      20-point ``lasso_path_sharded`` and ``lasso_row_sharded`` in the
      world of one's supports, ``lasso_lambda_batch`` at 4 λ within 1e-6
      of the single-device ``lasso``, every rank's result the same, K1 and
      K5 launched in each rank; a rank that fails fails the phase.
   m. the two paths of bench.py no earlier phase runs, at its shapes, on a
      world of one rank (NCCL): ``lasso_sharded`` at n = 1,000, p =
      1,000,000 (``bench.p1m_problem``: s = 100 planted, λ = 0.1·λmax,
      ``opt_tol=1e-6``), its float64 relative gap below 100·opt_tol and
      no coordinate more than 1e-4 from the single-device ``lasso``'s
      (phase 3's solve on the same X); the 20-point batched
      ``lasso_path_sharded``, certified without falling back (their
      launches at the shapes and routes of phase 3's p = 1M rows, from
      the wrappers' counts by shape, are those rows' launches, and each
      must be at least one); then the row tier ``lasso_row_sharded`` at
      50,000 x 2,000 (``bench.row_problem``, its launches kept apart)
      within 1e-4 of the single-device ``lasso``.  Times, launches and
      the phase's peak device memory are logged.
   Every kernel must have launched in the runs that drive it.  (The plain
   runs repeat the kernels' arithmetic in eager PyTorch and are no
   yardstick of speed; 4a's plain scan is the longest of them.)
5. ``python -m coordinatedescent_jl_tpu_torch.bench`` with
   ``BENCH_SMALL=1``, each demo of ``coordinatedescent_jl_tpu_torch/
   examples`` with ``--small`` and ``python -m coordinatedescent_jl_tpu_torch.
   multiproc_bench --small`` (its card mode: the worlds the cards allow,
   one card a rank), each a process of its own on the card, all started
   together: each must exit with 0, and the bench's two lines must carry
   the small metric's name, every compact key its small mode records
   (bench.py's list less the roofline, p = 1M and multi-process keys),
   every ``*_certified`` true and no ``*_error`` key; the scaling line
   must say ``cuda`` and hold a nonempty solution of the world of one.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA GPU; exits 1 without one.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
import warnings

# the H100 SXM's published non-tensor-core float32 / float64 peaks (NVIDIA's
# data sheet, dense, 700 W); its device-memory rate is the port's
# utils/profiling.py::H100_HBM_BYTES_PER_S
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


RETAKEN = []   # the traces one_call had to take again, one entry a call


def one_call(fn):
    """(host reads, device kernels' names, device ms) of one call of ``fn``
    under torch.profiler (``profile_paths.trace_one_call``, which retakes a
    trace that lost a launch its wrapper counted).  Fails unless the
    wrappers counted exactly one launch."""
    from coordinatedescent_jl_tpu_torch.profile_paths import trace_one_call

    reads, names, dms, counted, retaken = trace_one_call(fn)
    RETAKEN.append(retaken)
    if counted != 1:
        fail(f"one call counted {counted} launches, traced {names}")
    return reads, names, dms


def library_device_ms(fn) -> str:
    """The device ms of one call of a library function (no launch counter
    to retake a short trace by): the least of three traces that show a
    kernel, or "not measured"."""
    from coordinatedescent_jl_tpu_torch.profile_paths import trace_one_call

    got = [dms for _, names, dms, _, _ in (trace_one_call(fn)
                                           for _ in range(3)) if names]
    return f"{min(got):.4f}" if got else "not measured"


def maxdiff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bound_ms(nbytes: float, flops: float, peak: str):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    from coordinatedescent_jl_tpu_torch.utils.profiling import (
        H100_HBM_BYTES_PER_S)

    tb = nbytes / H100_HBM_BYTES_PER_S * 1e3
    to = flops / PEAK_FLOPS[peak] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def support_mismatch(a, b, tol):
    """Coordinates whose support differs between ``a`` and ``b`` while one
    of them is above ``tol`` in magnitude."""
    import torch

    differ = (a != 0) != (b != 0)
    return int((differ & (torch.maximum(a.abs(), b.abs()) > tol)).sum())


WORLD_B_P = 20_000


def _world_b_rank(p, lam, lam_row, lams, lams4):
    """One rank of 4l's world (b): the bench problem at ``p`` columns made
    on cuda:0 from seed 0 (the same bits in every rank), then
    ``lasso_sharded``, a 20-point ``lasso_path_sharded``,
    ``lasso_row_sharded`` and ``lasso_lambda_batch`` over two ranks; the
    results, the wall times and each run's kernel launch counts (reset
    before it, read after it)."""
    import torch
    from coordinatedescent_jl_tpu_torch.parallel import (
        distributed as pdist, lasso_lambda_batch, lasso_path_sharded,
        lasso_row_sharded, lasso_sharded)
    from coordinatedescent_jl_tpu_torch.profile_paths import (
        bench_problem, launch_counts, reset_launch_counts)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    bp = bench_problem(dev, p=p, seed=0)
    fmesh = pdist.feature_mesh()
    out, times, launches = {}, {}, {}
    runs = (
        ("lasso", lambda: lasso_sharded(bp.X, bp.y, lam, fmesh,
                                        options=bp.opts, device=dev).x),
        ("path", lambda: lasso_path_sharded(
            bp.X, bp.y, lams, fmesh, options=bp.opts, standardize_X=False,
            path_batch=0, device=dev).beta_path),
        ("row", lambda: lasso_row_sharded(bp.X, bp.y, lam_row,
                                          pdist.obs_mesh(), options=bp.opts,
                                          device=dev).x),
        ("batch", lambda: lasso_lambda_batch(
            bp.X, bp.y, lams4, pdist.make_mesh((2,), ("batch",)),
            options=bp.opts, device=dev)))
    for name, fn in runs:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out[name] = fn().cpu().numpy()
        times[name] = round(time.perf_counter() - t0, 3)
        launches[name] = launch_counts()
    out["times"] = times
    out["launches"] = launches
    # the union round's psum of the replicated (C, n) working set
    out["union_bytes"] = bp.opts.compact_size * bp.X.shape[0] * 4
    return out


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    try:
        import coordinatedescent_jl_tpu_torch as tcd
        from coordinatedescent_jl_tpu_torch import bench as pbench
        from coordinatedescent_jl_tpu_torch.kernels import (_build,
                                                            active_pass,
                                                            blockify,
                                                            check,
                                                            gradient_sweep,
                                                            group_pass,
                                                            union_fista,
                                                            vc_round)
        from coordinatedescent_jl_tpu_torch.models import polish as pol
        from coordinatedescent_jl_tpu_torch.models import (
            varying_coefficient as vcm)
        from coordinatedescent_jl_tpu_torch.ops import (batched_certify,
                                                        block_cd, group_cd)
        from coordinatedescent_jl_tpu_torch.ops.prox import fista_momentum
        from coordinatedescent_jl_tpu_torch.profile_paths import (
            bench_problem, group_bench_problem, launch_counts,
            reset_launch_counts, vc_bench_problem)
        from coordinatedescent_jl_tpu_torch.utils import checkpoint as ckpt
        from coordinatedescent_jl_tpu_torch.utils import host
        from coordinatedescent_jl_tpu_torch.utils import profiling as prof
        from torch.utils._python_dispatch import _get_current_dispatch_mode
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
               peak="f32", library_ms=None, device_ms=None):
        nonlocal ok
        good = err <= tol
        ok = ok and good
        bms, by = bound_ms(nbytes, flops, peak)
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        log(f"{name} [{what}]: max_abs_err {err:.3e} (tol {tol:.1e}) "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, bound "
            f"{bms:.4f} ms ({by}) {'ok' if good else 'MISMATCH'}")
        if key:
            # device_ms: one traced call's device time, where measured
            rec[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by, library_ms=library_ms,
                            device_ms=device_ms)

    def check_one_cta(tag, what, a_args, screens):
        """K3 (each of ``screens``; the first reported as ``K3_<tag>``) and
        K4 (on phase A's plain outputs at the first) on their one-CTA
        route: one ``check_a_cta`` / ``check_b_cta`` kernel a call and no
        host read, masks equal to the twins', bound and maxh within
        relative 1e-5, every output bit for bit the cooperative route's
        forced at one CTA, and both routes' device times."""
        nonlocal ok
        nb_k = a_args[0].shape[0]
        plan3 = check._plan(False, nb_k, B, dev.index)
        plan4 = check._plan(True, nb_k, B, dev.index)
        if not (plan3.cta and plan4.cta):
            fail(f"K3/K4 at {nb_k} rows must take the one-CTA route: "
                 f"{plan3}, {plan4}")
        same = {}

        def routes(name, fn, coop, plain, nbytes, flops, tol_of, masks_of,
                   kernel, key):
            nonlocal ok
            outk, outp, outc = fn(None), plain(), fn(coop)
            same[name] = all(torch.equal(x, y) for x, y in zip(outk, outc))
            masks = masks_of(outk, outp)
            err, tol = tol_of(outk, outp)
            ms = cuda_ms(lambda: fn(None), 50)
            pms = cuda_ms(plain, 20)
            reads, names, dms = one_call(lambda: fn(None))
            _, onames, odms = one_call(lambda: fn(coop))
            report(key, f"{kernel} ({tag})", err, tol, ms, pms,
                   f"{name}: {what}, one-CTA route; mask mismatches {masks}; "
                   f"one call: device {dms:.4f} ms, {len(names)} kernel(s) "
                   f"{[k.split('(')[0] for k in names]}, {reads} host reads; "
                   f"the cooperative route at one CTA: device {odms:.4f} ms, "
                   f"{len(onames)} kernel(s), bitwise equal {same[name]}",
                   nbytes, flops, device_ms=dms)
            ok = ok and masks == 0
            cta_name = "check_a_cta" if kernel == "K3" else "check_b_cta"
            if reads or len(names) != 1 or cta_name not in names[0]:
                fail(f"{kernel} at {nb_k} rows ({name}) must launch one "
                     f"{cta_name} kernel and read nothing to the host: "
                     f"{names}, {reads} host reads")
            return outp

        first = None
        for screen in screens:
            outp = routes(
                f"screen={screen}",
                lambda plan, screen=screen: check.check_phase_a(
                    *a_args, screen=screen, plan=plan),
                plan3._replace(coop=True),
                lambda screen=screen: check.check_phase_a_plain(
                    *a_args, screen=screen),
                f4 * (7 * nb_k * B + 5 * nb_k + 5), 40 * nb_k * B,
                lambda k, q: (max(maxdiff(k[3], q[3]), maxdiff(k[4], q[4])),
                              1e-5 * max(1.0, float(q[3].abs().max()))),
                lambda k, q: sum(int((k[i] != q[i]).sum())
                                 for i in (0, 1, 2, 5)),
                "K3", f"K3_{tag}" if first is None else None)
            if first is None:
                first = outp
        b_args = (a_args[0], a_args[1], first[3], first[1], first[2],
                  *a_args[3:])
        routes("phase B", lambda plan: check.check_phase_b(*b_args,
                                                           plan=plan),
               plan4._replace(coop=True),
               lambda: check.check_phase_b_plain(*b_args),
               f4 * (7 * nb_k * B + 3 * nb_k + 5), 20 * nb_k * B,
               lambda k, q: (maxdiff(k[0], q[0]),
                             1e-5 * max(1.0, float(q[0]))),
               lambda k, q: int((k[1] != q[1]).sum()), "K4", f"K4_{tag}")
        log(f"K3/K4 ({tag}) one-CTA route against the cooperative route at "
            f"one CTA, bitwise: {same}")
        if not all(same.values()):
            fail(f"the one-CTA route differs from the cooperative route "
                 f"({tag})")

    def check_coop(tag, what, a_args):
        """K3 (screen on, reported as ``K3<tag>``, and off) and K4 (on phase
        A's plain screen-on outputs, ``K4<tag>``) on the cooperative route
        its plan names: masks equal to the twins', bound and maxh within
        relative 1e-5, one ``check_a_kernel`` / ``check_b_kernel`` a call
        and no host read; the bytes are six (nb, B) inputs and the bound
        out and the per-block rows, about 40 elementwise operations a
        coordinate in phase A, 20 in phase B."""
        nonlocal ok
        nb_k = a_args[0].shape[0]
        for phase_b in (False, True):
            if check._plan(phase_b, nb_k, B, dev.index).cta:
                fail(f"K3/K4 at {nb_k} rows must take the cooperative route")
        for screen in (True, False):
            outk = check.check_phase_a(*a_args, screen=screen)
            outp = check.check_phase_a_plain(*a_args, screen=screen)
            masks = sum(int((outk[i] != outp[i]).sum()) for i in (0, 1, 2, 5))
            err = max(maxdiff(outk[3], outp[3]), maxdiff(outk[4], outp[4]))
            tol = 1e-5 * max(1.0, float(outp[3].abs().max()))
            ms = cuda_ms(lambda: check.check_phase_a(*a_args, screen=screen),
                         50)
            pms = cuda_ms(lambda: check.check_phase_a_plain(*a_args,
                                                            screen=screen), 20)
            reads, names, dms = one_call(
                lambda: check.check_phase_a(*a_args, screen=screen))
            report(f"K3{tag}" if screen else None, "K3 check_phase_a", err,
                   tol, ms, pms, f"{what}, screen={screen}; mask mismatches "
                   f"{masks}; need {int(outp[0].sum())}; one call: device "
                   f"{dms:.4f} ms, {len(names)} kernel(s), {reads} host reads",
                   f4 * (7 * nb_k * B + 5 * nb_k + 5), 40 * nb_k * B,
                   device_ms=dms)
            ok = ok and masks == 0
            if reads or len(names) != 1 or "check_a_kernel" not in names[0]:
                fail(f"check_phase_a at {nb_k} rows must launch one "
                     f"check_a_kernel and read nothing to the host: {names}")
            if screen:
                first = outp
        b_args = (a_args[0], a_args[1], first[3], first[1], first[2],
                  *a_args[3:])
        outk = check.check_phase_b(*b_args)
        outp = check.check_phase_b_plain(*b_args)
        masks = int((outk[1] != outp[1]).sum())
        ms = cuda_ms(lambda: check.check_phase_b(*b_args), 50)
        pms = cuda_ms(lambda: check.check_phase_b_plain(*b_args), 20)
        reads, names, dms = one_call(lambda: check.check_phase_b(*b_args))
        report(f"K4{tag}", "K4 check_phase_b", maxdiff(outk[0], outp[0]),
               1e-5 * max(1.0, float(outp[0])), ms, pms,
               f"{what}; mask mismatches {masks}; one call: device {dms:.4f} "
               f"ms, {len(names)} kernel(s), {reads} host reads",
               f4 * (7 * nb_k * B + 3 * nb_k + 5), 20 * nb_k * B,
               device_ms=dms)
        ok = ok and masks == 0
        if reads or len(names) != 1 or "check_b_kernel" not in names[0]:
            fail(f"check_phase_b at {nb_k} rows must launch one "
                 f"check_b_kernel and read nothing to the host: {names}")

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
    plan = gs.sweep_plan(ws.Xwb)
    ms = cuda_ms(lambda: gs.fused_gradient_sweep(ws.Xwb, st.r), 50)
    pms = cuda_ms(lambda: gs.fused_gradient_sweep_plain(ws.Xwb, st.r), 50)
    lms = cuda_ms(lambda: torch.matmul(st.r, ws.Xwb), 50)
    _, names, dms = one_call(lambda: gs.fused_gradient_sweep(ws.Xwb, st.r))
    ldms = library_device_ms(lambda: torch.matmul(st.r, ws.Xwb))
    report(None, "K5 fused_gradient_sweep", maxdiff(ck, cp),
           1e-5 * float(cp.abs().max()), ms, pms,
           f"8-block working set, split {plan.split} x {plan.rows} rows"
           f"{' (one cluster a tile)' if plan.cluster else ', two kernels'}; "
           f"one call: device {dms:.4f} ms, {len(names)} kernel(s); "
           f"library device {ldms} ms",
           f4 * (8 * n * B + n + 8 * B), 2 * 8 * n * B, library_ms=lms)

    # K1's wls and sqrt forms on the same 8-block working set.  Tolerances
    # as for ls (beta, maxh 1e-4; r 1e-3 over |r| ~ 1e2); the returned
    # rsqr = ||r||^2 ~ 1e4 relative: 1e-5 (a sum of n = 10K f32 squares in
    # another order; through the exact scan it also carries the
    # cancellation of 1024 three-term updates).
    def k1_kind(key, what, prob_k, st_k, lam_k, kind, inner, nbytes, flops,
                reps_plain):
        nonlocal ok
        args = (prob_k, st_k.beta, st_k.r, act8, lam_k, float(n), border8,
                corder)
        kw = dict(kind=kind, inner=inner, iters=16,
                  rsqr=torch.dot(st_k.r, st_k.r))
        bk, rk, mk, sk = active_pass.fused_active_pass(*args, **kw)
        bp_, rp, mp, sp = active_pass.fused_active_pass_plain(*args, **kw)
        err = max(maxdiff(bk, bp_), maxdiff(mk, mp))
        errr = maxdiff(rk, rp)
        errs = abs(float(sk) - float(sp)) / max(abs(float(sp)), 1e-30)
        ms = cuda_ms(lambda: active_pass.fused_active_pass(*args, **kw), 20)
        pms = cuda_ms(lambda: active_pass.fused_active_pass_plain(
            *args, **kw), reps_plain)
        reads, names, dms = one_call(
            lambda: active_pass.fused_active_pass(*args, **kw))
        report(key, f"K1 fused_active_pass ({kind})", err, 1e-4, ms, pms,
               f"{what}; r err {errr:.2e} (tol 1.0e-03); rsqr "
               f"{float(sk):.6e} rel err {errs:.2e} (tol 1.0e-05); nnz "
               f"{int((bk != 0).sum())}; one call: device {dms:.4f} ms, "
               f"{len(names)} kernel(s), {reads} host reads", nbytes, flops,
               device_ms=dms)
        ok = ok and errr <= 1e-3 and errs <= 1e-5
        if kind == "sqrt" and float(sk) == float(kw["rsqr"]):
            fail("the sqrt pass returned its input rsqr")
        if reads or len(names) != 1:
            fail(f"fused_active_pass ({kind}) must launch one kernel and "
                 "read nothing to the host")

    w_rows = 0.5 + torch.rand(n, generator=g, device=dev)
    for gram_on in (True, False):
        wsw = block_cd.build_blocked(
            "wls", opts.replace(cache_gram=gram_on, compact=False),
            torch.ones(1024, device=dev), X=X[:, cols].contiguous(), y=y,
            w=w_rows)
        if (wsw.Kb is not None) != gram_on or wsw.Xwb is wsw.Xb:
            fail("the wls working set must hold a second design")
        stw = block_cd._init_state("wls", wsw, bws, None)
        # bytes: both designs' 8 blocks (each read once), else as ls;
        # flops: as ls, and without a Gram 2 n B^2 a block more
        k1_kind("K1wls" if gram_on else None,
                f"8 blocks, Gram {'on' if gram_on else 'off'}, ista",
                wsw, stw, lam0, "wls", "ista",
                k1_bytes + f4 * 8 * n * B - (0 if gram_on else f4 * 8 * B * B),
                k1_flops + (0 if gram_on else 8 * 2 * n * B * B), 10)
        del wsw, stw
    lam_sq = 1.1 * math.sqrt(2 * math.log(p))
    wss = block_cd.build_blocked("sqrt", ws_opts, torch.ones(1024, device=dev),
                                 X=X[:, cols].contiguous(), y=y)
    sts = block_cd._init_state("sqrt", wss, bws, None)
    k1_kind("K1sqrt", "8 blocks, Gram on, ista", wss, sts, lam_sq, "sqrt",
            "ista", k1_bytes + f4, k1_flops + 8 * 2 * n, 10)
    # the exact scan: ~40 operations a coordinate instead of FISTA's steps
    k1_kind(None, "8 blocks, Gram on, exact", wss, sts, lam_sq, "sqrt",
            "exact", k1_bytes + f4, 8 * (4 * n * B + 2 * B * B + 40 * B), 2)
    del ws, st, wss, sts

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

    # K1's sqrt form in float64 with the exact inner: the sqrt polish's
    # inner solve on its own inputs, the support of a sqrt_lasso at
    # bench.py's level padded to the polish's allocation, ||r||^2 refreshed
    # as each of its sweeps starts.  Tolerances as for K1 f64; rsqr 1e-11
    # relative.
    opts_sq = tcd.CDOptions(opt_tol=1e-6, max_iter=300, randomize=False,
                            block_size=B)
    sol_sq = tcd.sqrt_lasso(X, y, lam_sq, options=opts_sq,
                            standardize_X=False)
    sup0 = torch.nonzero(sol_sq.x).flatten()
    ns0 = sup0.numel()
    C0 = pol._allocation(ns0, p, 4096)
    idx0 = torch.full((C0,), p, dtype=torch.int64, device=dev)
    idx0[:ns0] = sup0
    beta00 = torch.zeros((C0,), dtype=torch.float64, device=dev)
    beta00[:ns0] = sol_sq.x[sup0].double()
    prob64, st64, _ = pol._restricted_problem(
        X, y.double(), torch.ones(p, dtype=torch.float64, device=dev), idx0,
        beta00)
    nb64 = prob64.lamw.shape[0]
    args = (prob64, st64.beta, st64.r, st64.active, lam_sq, float(n),
            torch.arange(nb64, device=dev), corder)
    kw = dict(kind="sqrt", inner="exact", rsqr=torch.dot(st64.r, st64.r))
    bk, rk, mk, sk = active_pass.fused_active_pass(*args, **kw)
    bp64, rp, mp, sp = active_pass.fused_active_pass_plain(*args, **kw)
    err = max(maxdiff(bk, bp64), maxdiff(mk, mp))
    errr = maxdiff(rk, rp)
    errs = abs(float(sk) - float(sp)) / float(sp)
    ms = cuda_ms(lambda: active_pass.fused_active_pass(*args, **kw), 20)
    pms = cuda_ms(lambda: active_pass.fused_active_pass_plain(*args, **kw), 2)
    reads, names, dms = one_call(
        lambda: active_pass.fused_active_pass(*args, **kw))
    report("K1sqrt_f64", "K1 fused_active_pass (sqrt)", err,
           1e-11 * max(1.0, float(bp64.abs().max())), ms, pms,
           f"float64, the sqrt polish's {nb64} block(s) of support {ns0}, "
           f"Gram on, exact; r err {errr:.2e}; rsqr rel err {errs:.2e} (tol "
           f"1.0e-11); one call: device {dms:.4f} ms, {len(names)} "
           f"kernel(s), {reads} host reads",
           8 * (nb64 * n * B + nb64 * B * B + 4 * nb64 * B + 2 * n + 1),
           nb64 * (4 * n * B + 2 * B * B + 40 * B), peak="f64",
           device_ms=dms)
    ok = ok and errr <= 1e-11 * float(rp.abs().max()) and errs <= 1e-11
    if reads or len(names) != 1:
        fail("fused_active_pass (sqrt, float64) must launch one kernel and "
             "read nothing to the host")
    del prob64, st64, args, sol_sq

    # BL, the design's set-up copy (build_blocked's ls and sqrt kinds and
    # the unweighted group build): the padded blocked design bit for bit
    # the twin's, its padding +0, the columns' sums of squares within one
    # ulp of the float64 sum rounded to float32
    def blockify_row(key, Xd, what):
        nd, pd = Xd.shape
        nbd = -(-pd // B)
        Xk, sk = blockify.blockify(Xd, B)
        Xq, _ = blockify.blockify_plain(Xd, B)
        pad = Xk[-1, :, pd - (nbd - 1) * B:].contiguous()
        same = torch.equal(Xk, Xq) and not pad.view(torch.int32).any()
        ref = torch.cat([torch.sum(Xq[i:i + 64].double() ** 2, dim=1)
                         for i in range(0, nbd, 64)]).float()
        del Xk, Xq, pad
        up = torch.nextafter(ref, torch.full_like(ref, float("inf")))
        err = float(((sk.double() - ref.double()).abs()
                     / (up.double() - ref.double())).max())
        del sk, ref, up
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: blockify.blockify(Xd, B), 10)
        pms = cuda_ms(lambda: blockify.blockify_plain(Xd, B), 3)
        reads, names, dms = one_call(lambda: blockify.blockify(Xd, B))
        nbytes = f4 * (nd * pd + nbd * nd * B)
        report(key, "BL blockify", err, 1.0, ms, pms,
               f"({nd}, {pd}) f32 -> ({nbd}, {nd}, {B}); error in ulps of "
               f"the float64 sums rounded; Xb bitwise the twin's, padding "
               f"+0: {same}; one call: device {dms:.4f} ms, {len(names)} "
               f"kernel(s), {reads} host reads; the bound is "
               f"{bound_ms(nbytes, 2 * nd * pd, 'f32')[0] / dms:.1%} of the "
               f"device time; {what}", nbytes, 2 * nd * pd, device_ms=dms)
        if not same:
            fail(f"blockify at ({nd}, {pd}) differs from its twin's copy")
        if reads or not 1 <= len(names) <= 2 or "blockify_kernel" not in \
                names[0]:
            fail(f"blockify must launch blockify_kernel (and at most its "
                 f"reduction) and read nothing to the host: {names}, "
                 f"{reads} reads")

    blockify_row("BL", X, "the 10K path's set-up")

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
    # order than the plain product: relative 1e-5 of max|c|.  Timed as the
    # engine calls it, with the host's count of needed blocks (without it
    # the wrapper reads the count from the card on every call)
    need = torch.rand(nb_full, generator=g, device=dev) < 0.3
    c_prev = torch.randn((nb_full, B), generator=g, device=dev)
    nn = int(need.sum())
    ck = gs.restricted_gradient_sweep(full.Xwb, st.r, need, c_prev)
    cp = gs.restricted_gradient_sweep_plain(full.Xwb, st.r, need, c_prev)
    err = maxdiff(ck, cp)
    tol = 1e-5 * float(cp.abs().max())
    ms = cuda_ms(lambda: gs.restricted_gradient_sweep(
        full.Xwb, st.r, need, c_prev, n_need=nn), 10)
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

    # LD, the loadings sweep on the blocked design (get_loadings_blocked:
    # the float32 rounds of feasible_lasso), w = r²: sums of n = 10K
    # positive terms in other orders than the twin's batched products,
    # relative 1e-5 column by column; the padded columns exactly 0
    w = st.r * st.r
    lk = gs.loadings_sweep(full.Xb, w)
    lp = gs.loadings_sweep_plain(full.Xb, w)
    err = float(((lk.double() - lp.double()).abs()
                 / lp.double().clamp_min(1e-30))[full.valid].max())
    ok = ok and not lk[~full.valid].any()
    ms = cuda_ms(lambda: gs.loadings_sweep(full.Xb, w), 10)
    pms = cuda_ms(lambda: gs.loadings_sweep_plain(full.Xb, w), 3)
    reads, names, dms = one_call(lambda: gs.loadings_sweep(full.Xb, w))
    report("LD", "LD loadings_sweep", err, 1e-5, ms, pms,
           f"all {nb_full} blocks, float32, relative error; one call: "
           f"device {dms:.4f} ms, {len(names)} kernel(s), {reads} host "
           f"reads", f4 * (nb_full * n * B + n + nb_full * B),
           3 * nb_full * n * B, device_ms=dms)
    if reads or len(names) != 1 or "loadings_kernel" not in names[0]:
        fail(f"loadings_sweep must launch one loadings_kernel and read "
             f"nothing to the host: {names}, {reads} reads")
    del lk, lp, w

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
    check_coop("", f"{nb_full} rows", (c_full, st.beta, drift, full.adiag,
                                       full.lamw, validf, full.xwnorm, scal))
    # K3/K4 on the working set's 8 blocks (the lasso's inner solves, screen
    # on): 4 blocks of the planted support and 4 without, gathered from
    # the state above, on their one-CTA route
    act_rows = torch.nonzero(st.active).flatten()
    idle_rows = torch.nonzero(~st.active).flatten()
    rows8 = torch.sort(torch.cat([act_rows[:4], idle_rows[:4]]))[0]
    check_one_cta("ws", "the 8-block working set", tuple(
        t[rows8].contiguous() for t in (c_full, st.beta, drift, full.adiag,
                                        full.lamw, validf, full.xwnorm))
        + (scal,), (True, False))
    del full, st, args, c_full, bk, rk, bp, rp, ck, cp
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
    # LD float64 (loadings_f64: the feasible polish's loadings), w = r64²
    # on the dense design: each element widened and squared exactly in
    # float64; sums of n = 10K positive terms, relative 1e-12
    w64 = r64 * r64
    lk = gs.loadings_f64_sweep(X, w64)
    lp = gs.loadings_f64_sweep_plain(X, w64)
    err = float(((lk - lp).abs() / lp.clamp_min(1e-300)).max())
    ms = cuda_ms(lambda: gs.loadings_f64_sweep(X, w64), 10)
    pms = cuda_ms(lambda: gs.loadings_f64_sweep_plain(X, w64), 3)
    reads, names, dms = one_call(lambda: gs.loadings_f64_sweep(X, w64))
    report("LDf64", "LD loadings_f64_sweep", err, 1e-12, ms, pms,
           f"dense ({n}, {p}) f32, f64 w, squares and accumulation, "
           f"relative error; one call: device {dms:.4f} ms, {len(names)} "
           f"kernel(s), {reads} host reads",
           f4 * n * p + 8 * n + 8 * p, 3 * n * p, peak="f64", device_ms=dms)
    if reads or len(names) != 1 or "loadings_kernel" not in names[0]:
        fail(f"loadings_f64_sweep must launch one loadings_kernel and read "
             f"nothing to the host: {names}, {reads} reads")
    del gk, gp, r64, lk, lp, w64
    torch.cuda.empty_cache()

    # The varying-coefficient scan's problem (4j): one grid point of
    # bench.py's configuration at z0 = 0.5, built as the scan builds it
    # (n = 500, 100 expanded columns in one block of 128, f32, the default
    # options: a cached Gram, no compaction), from 0.9 of the point's
    # solution.  K1 runs its small-n plan there (the JAX package's resident
    # pass K1′: one cluster of 16 CTAs of 32 rows), K5 one column tile
    # split in 16 slices, one cluster, K3/K4 one CTA.  The bytes are below
    # one launch's latency (~0.2 us): the device time of one call is the
    # yardstick.  Tolerances as above.  Each cluster route is also held bit
    # for bit against the route it replaced, at the same plan: K1's
    # cooperative grid of the same CTAs and rows, K5's two kernels (the
    # partials through HBM, the reduce kernel) at the same slices.
    vp = vc_bench_problem(dev)
    kern_v = tcd.GaussianKernel(vp.h)
    nv = vp.X.shape[0]
    w_v = tcd.evaluate(kern_v, vp.z, 0.5)
    eX_v = tcd.expand_X(vp.X, vp.z, 0.5, vp.degree)
    opts_v = tcd.CDOptions()
    lamw_v = tcd.std_X(eX_v, w_v)
    prob_v = block_cd.build_blocked("wls", opts_v, lamw_v, X=eX_v, y=vp.y,
                                    w=w_v)
    if prob_v.Kb is None or tuple(prob_v.lamw.shape) != (1, B):
        fail("the varying-coefficient point must be one block with a Gram")
    b_v, _ = tcd.coordinate_descent(
        torch.zeros(eX_v.shape[1], device=dev),
        tcd.WeightedLSLoss(vp.y, eX_v, w_v), tcd.ProxL1(vp.lam0, lamw_v),
        opts_v)
    st_v = block_cd._init_state("wls", prob_v, block_cd._to_blocked_beta(
        0.9 * b_v, B).contiguous(), None)
    plan_v = active_pass.card_plan(nv, B, torch.float32, dev, True, "wls")
    if not plan_v.cluster:
        fail(f"K1 at n = {nv} must take the cluster route: {plan_v}")
    # the card's occupancy query: clusters of this shape it holds at once
    held_v = _build.active_clusters("cdt_active_pass_clusters_f32",
                                    dev.index, 1, plan_v.smem, plan_v.grid)
    if held_v < 1:
        fail(f"the card holds no cluster of K1's plan {plan_v}")
    coop_v = active_pass.on_route(plan_v, False, B, 4)
    routes_same = {}
    one = torch.arange(1, device=dev)
    act_v = torch.ones(1, dtype=torch.bool, device=dev)
    for inner in ("ista", "exact"):
        args = (prob_v, st_v.beta, st_v.r, act_v, vp.lam0, float(nv), one,
                corder)
        # as the engine calls it, with the state's rsqr (without it the
        # wrapper makes a zero on the card: a second kernel)
        kw = dict(kind="wls", inner=inner, iters=16, rsqr=st_v.rsqr)
        bk, rk, mk, _ = active_pass.fused_active_pass(*args, **kw)
        bp_, rp, mp, _ = active_pass.fused_active_pass_plain(*args, **kw)
        err = max(maxdiff(bk, bp_), maxdiff(mk, mp))
        errr = maxdiff(rk, rp)
        ms = cuda_ms(lambda: active_pass.fused_active_pass(*args, **kw), 50)
        pms = cuda_ms(lambda: active_pass.fused_active_pass_plain(
            *args, **kw), 3 if inner == "exact" else 10)
        reads, names, dms = one_call(
            lambda: active_pass.fused_active_pass(*args, **kw))
        # the previous route once, at the same CTAs and rows: the same bits
        oc = active_pass.fused_active_pass(*args, **kw, plan=coop_v)
        routes_same[f"K1 {inner}"] = all(
            torch.equal(a, c) for a, c in zip((bk, rk, mk), oc[:3]))
        _, onames, odms = one_call(
            lambda: active_pass.fused_active_pass(*args, **kw, plan=coop_v))
        # bytes: both designs' block, the Gram, lamw, beta in and out, r in
        # and out; flops: c and the residual update, then 16 FISTA steps
        # (or the exact scan's Gram recursion)
        report("K1wls_vc" if inner == "ista" else None,
               "K1 fused_active_pass (wls)", err, 1e-4, ms, pms,
               f"one block at n = {nv}, cluster route ({plan_v.grid} CTAs "
               f"of {plan_v.rows} rows, {plan_v.smem} B of shared memory, "
               f"{held_v} such clusters held at once), "
               f"Gram cached, {inner}; r err "
               f"{errr:.2e} (tol 1.0e-03); nnz {int((bk != 0).sum())}; one "
               f"call: device {dms:.4f} ms, {len(names)} kernel(s), {reads} "
               f"host reads; the cooperative route at the same plan: device "
               f"{odms:.4f} ms, {len(onames)} kernel(s), bitwise equal "
               f"{routes_same[f'K1 {inner}']}",
               f4 * (2 * nv * B + B * B + 3 * B + 2 * nv),
               4 * nv * B + (16 * 2 * B * B if inner == "ista"
                             else 2 * B * B + 40 * B), device_ms=dms)
        ok = ok and errr <= 1e-3
        if reads or len(names) != 1:
            fail("fused_active_pass (wls, n = 500) must launch one kernel "
                 "and read nothing to the host")
    ck = gs.fused_gradient_sweep(prob_v.Xwb, st_v.r)
    cp = gs.fused_gradient_sweep_plain(prob_v.Xwb, st_v.r)
    plan5 = gs.sweep_plan(prob_v.Xwb)
    if not plan5.cluster:
        fail(f"K5 at (1, {nv}, {B}) must take the cluster route: {plan5}")
    held5 = _build.active_clusters("cdt_dense_sweep_f32_clusters", dev.index,
                                   plan5.split)
    if held5 < 1:
        fail(f"the card holds no cluster of K5's plan {plan5}")
    two5 = plan5._replace(cluster=False, grid=plan5.tiles * plan5.split)
    routes_same["K5"] = torch.equal(ck, gs.fused_gradient_sweep(
        prob_v.Xwb, st_v.r, plan=two5))
    ms = cuda_ms(lambda: gs.fused_gradient_sweep(prob_v.Xwb, st_v.r), 50)
    pms = cuda_ms(lambda: gs.fused_gradient_sweep_plain(prob_v.Xwb, st_v.r),
                  50)
    lms = cuda_ms(lambda: torch.matmul(st_v.r, prob_v.Xwb), 50)
    reads, names, dms = one_call(
        lambda: gs.fused_gradient_sweep(prob_v.Xwb, st_v.r))
    _, onames, odms = one_call(
        lambda: gs.fused_gradient_sweep(prob_v.Xwb, st_v.r, plan=two5))
    ldms = library_device_ms(lambda: torch.matmul(st_v.r, prob_v.Xwb))
    report("K5_vc", "K5 fused_gradient_sweep", maxdiff(ck, cp),
           1e-5 * float(cp.abs().max()), ms, pms,
           f"one block (1, {nv}, {B}), split {plan5.split} x {plan5.rows} "
           f"rows, one cluster ({held5} held at once); one call: device "
           f"{dms:.4f} ms, {len(names)} "
           f"kernel(s), {reads} host reads, library device {ldms} ms; the "
           f"two-kernel route at the same slices: device {odms:.4f} ms, "
           f"{len(onames)} kernel(s), bitwise equal {routes_same['K5']}",
           f4 * (nv * B + nv + B), 2 * nv * B, library_ms=lms,
           device_ms=dms)
    if reads or len(names) != 1:
        fail("fused_gradient_sweep (one block) must launch one kernel and "
             "read nothing to the host")
    log(f"cluster routes against their previous routes at the same plan, "
        f"bitwise: {routes_same}")
    if not all(routes_same.values()):
        fail("a cluster route differs from its previous route")
    c_v = block_cd._full_gradient_c("wls", prob_v, st_v.r, kernels=False)
    drift_v = torch.full((1,), 1e-3, device=dev)
    scal_v = block_cd._check_scalars(vp.lam0, float(nv),
                                     torch.dot(st_v.r, st_v.r),
                                     torch.zeros((), device=dev), 1e-7)
    valid_v = prob_v.valid.float()
    a_args = (c_v, st_v.beta, drift_v, prob_v.adiag, prob_v.lamw, valid_v,
              prob_v.xwnorm, scal_v)
    # K3/K4 at one block: the plain one-CTA route, held against the twin
    # and bit for bit against the cooperative route forced at one CTA
    check_one_cta("vc", "one block", a_args, (False,))
    del prob_v, st_v, eX_v, a_args
    # The kernels at the p = 1M shapes of 4m (bench.py:1098-1193): the
    # single-device lasso at n = 1,000, p = 1,000,000 (its solution, kept
    # as x_p1m, is 4m's reference), then, on the blocked design and a state
    # at 0.9 of its solution, K5 at (7,813, 1,000, 128), K3/K4 at 7,813
    # rows on the cooperative route, and K1 on its cluster route at n =
    # 1,000 over the solve's working set; tolerances as above
    X1, y1, lam1 = pbench.p1m_problem(dev)
    n1, p1 = X1.shape
    opts1 = tcd.CDOptions(opt_tol=pbench.OPT_TOL, randomize=False)
    sol1 = tcd.lasso(X1, y1, lam1, options=opts1)
    blockify_row("BL_p1m", X1, "the p = 1M set-up: one row chunk")
    full1 = block_cd.build_blocked("ls", opts1, torch.ones(p1, device=dev),
                                   X=X1, y=y1)
    nb1 = full1.lamw.shape[0]
    b1 = block_cd._to_blocked_beta(sol1.x, B)
    st1 = block_cd._init_state("ls", full1, (0.9 * b1).contiguous(), None)
    ck = gs.fused_gradient_sweep(full1.Xwb, st1.r)
    cp = gs.fused_gradient_sweep_plain(full1.Xwb, st1.r)
    plan1 = gs.sweep_plan(full1.Xwb)
    ms = cuda_ms(lambda: gs.fused_gradient_sweep(full1.Xwb, st1.r), 10)
    pms = cuda_ms(lambda: gs.fused_gradient_sweep_plain(full1.Xwb, st1.r), 10)
    lms = cuda_ms(lambda: torch.matmul(st1.r, full1.Xwb), 10)
    reads, names, dms = one_call(
        lambda: gs.fused_gradient_sweep(full1.Xwb, st1.r))
    two = plan1.split > 1 and not plan1.cluster
    report("K5_p1m", "K5 fused_gradient_sweep", maxdiff(ck, cp),
           1e-5 * float(cp.abs().max()), ms, pms,
           f"all {nb1} blocks of ({n1}, {B}), plan {tuple(plan1)}; one call: "
           f"device {dms:.4f} ms, {len(names)} kernel(s), {reads} host reads",
           f4 * (nb1 * n1 * B + n1 + nb1 * B), 2 * nb1 * n1 * B,
           library_ms=lms, device_ms=dms)
    heads = [k.split("(")[0].replace(" ", "") for k in names]
    if (reads or len(names) != 1 + two or "sweep_kernel" not in heads[0]
            or heads[0].endswith("true>") != plan1.cluster):
        fail(f"K5 at {nb1} blocks must launch its plan's route {plan1} and "
             f"read nothing to the host: {names}, {reads} host reads")
    del ck, cp
    # K3/K4 at 7,813 rows: fresh c, a drift on half of the blocks
    c1 = block_cd._full_gradient_c("ls", full1, st1.r, kernels=False)
    drift1 = torch.where(torch.rand(nb1, generator=g, device=dev) < 0.5,
                         torch.rand(nb1, generator=g, device=dev) * 1e-3,
                         torch.zeros(nb1, device=dev))
    scal1 = block_cd._check_scalars(lam1, float(n1), torch.dot(st1.r, st1.r),
                                    torch.dot(st1.r, y1), 1e-6)
    check_coop("_p1m", f"{nb1} rows at p = {p1}",
               (c1, st1.beta, drift1, full1.adiag, full1.lamw,
                full1.valid.float(), full1.xwnorm, scal1))
    # K1 on its cluster route at n = 1,000: one pass over the solve's working
    # set, the 8 blocks that hold most of its support, Grams cached
    blocks8 = torch.sort(torch.argsort((b1 != 0).sum(dim=1), descending=True,
                                       stable=True)[:8])[0]
    cols1 = (blocks8[:, None] * B + torch.arange(B, device=dev)).flatten()
    cols1 = cols1[cols1 < p1]
    del full1, st1, c1
    torch.cuda.empty_cache()
    ws1 = block_cd.build_blocked("ls", opts1.replace(cache_gram=True),
                                 torch.ones(cols1.numel(), device=dev),
                                 X=X1[:, cols1].contiguous(), y=y1)
    bw1 = ws1.lamw.shape[0]
    st_w = block_cd._init_state("ls", ws1, block_cd._to_blocked_beta(
        0.9 * sol1.x[cols1], B).contiguous(), None)
    plan_k1 = active_pass.card_plan(n1, B, torch.float32, dev, True, "ls")
    if not plan_k1.cluster:
        fail(f"K1 at n = {n1} must take the cluster route: {plan_k1}")
    args = (ws1, st_w.beta, st_w.r, torch.ones(bw1, dtype=torch.bool,
                                               device=dev), lam1, float(n1),
            torch.arange(bw1, device=dev), corder)
    kw = dict(kind="ls", inner="ista", iters=16, rsqr=st_w.rsqr)
    bk, rk, mk, _ = active_pass.fused_active_pass(*args, **kw)
    bp_, rp, mp, _ = active_pass.fused_active_pass_plain(*args, **kw)
    errr = maxdiff(rk, rp)
    ms = cuda_ms(lambda: active_pass.fused_active_pass(*args, **kw), 20)
    pms = cuda_ms(lambda: active_pass.fused_active_pass_plain(*args, **kw),
                  10)
    reads, names, dms = one_call(
        lambda: active_pass.fused_active_pass(*args, **kw))
    report("K1_n1000", "K1 fused_active_pass", max(maxdiff(bk, bp_),
                                                   maxdiff(mk, mp)), 1e-4,
           ms, pms, f"{bw1} blocks of the p = {p1} solve's working set at n "
           f"= {n1}, cluster route ({plan_k1.grid} CTAs of {plan_k1.rows} "
           f"rows, {plan_k1.smem} B of shared memory), Gram cached, ista; r "
           f"err {errr:.2e} (tol 1.0e-03); nnz {int((bk != 0).sum())}; one "
           f"call: device {dms:.4f} ms, {len(names)} kernel(s), {reads} host "
           f"reads", f4 * (bw1 * n1 * B + bw1 * B * B + 3 * bw1 * B + 2 * n1),
           bw1 * (4 * n1 * B + 16 * 2 * B * B), device_ms=dms)
    ok = ok and errr <= 1e-3
    head = names[0].split("(")[0].replace(" ", "") if names else ""
    if reads or len(names) != 1 or not head.endswith("true>"):
        fail(f"K1 at n = {n1} must launch one kernel on the cluster route "
             f"and read nothing to the host: {names}, {reads} host reads")
    x_p1m = sol1.x
    del ws1, st_w, args, bk, rk, bp_, rp, sol1, X1, y1
    torch.cuda.empty_cache()

    log(f"one-call traces: {len(RETAKEN)}, retaken {sum(RETAKEN)} (the "
        "tracer dropped a launch the wrapper counted)")
    if not ok:
        fail("a kernel disagrees with its plain twin")

    # ---- 4. the main paths ----------------------------------------------
    def counts():
        # every wrapper's count, and K3's / K4's launches on the one-CTA
        # route (the working sets' checks)
        return {**launch_counts(), "K3_ws": check.cta_launches("a"),
                "K4_ws": check.cta_launches("b")}

    def reset_counts():
        reset_launch_counts()
        host.reset()

    def require_launches(path, launches, keys, never=()):
        missing = [k for k in keys if launches[k] == 0]
        if missing:
            fail(f"kernels not launched by the {path} run: {missing}")
        wrong = [k for k in never if launches[k]]
        if wrong:
            fail(f"kernels the {path} run must never launch: {wrong}")

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
    require_launches("scan", launches, ("K1", "K2", "K3", "K4", "K5",
                                        "K3_ws", "K4_ws", "BL"))
    add(launches)
    ws_launches = {k: launches[k] for k in ("K3_ws", "K4_ws")}
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
    # the least-squares refit on the supports of the path's last 5 points,
    # on the card: each must satisfy its normal equations in float64
    host.reset()
    refits, t_refit = wall(lambda: tcd.refit_lasso_path(
        tcd.LassoPath(path.lam_path[-5:], path.beta_path[-5:]), X, y))
    worst = 0.0
    for S, coef in refits.items():
        if not (coef.is_cuda and coef.shape == (len(S),)):
            fail("refit_lasso_path: a refit is not on the card or misshapen")
        Xs = X[:, list(S)].double()
        res = y.double() - Xs @ coef.double()
        worst = max(worst, float((res @ Xs).abs().max() / (y.double() @ Xs).abs().max()))
    log(f"refit_lasso_path: {len(refits)} distinct support(s) of the last 5 "
        f"points in {t_refit:.3f} s, {host.COUNTS['host_reads']} host "
        f"read(s); max |X_S'(y - X_S b)| / max |X_S'y| {worst:.2e} (tol "
        "1.0e-04)")
    if not refits or not worst <= 1e-4:
        fail("refit_lasso_path: the normal equations do not hold")
    del refits
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
    require_launches("batched path", launches, ("K1", "K3", "K4", "K5",
                                                "union_fista"))
    if launches["union_fista"] != st_b["refine_rounds"]:
        fail(f"the batched path launched union_fista "
             f"{launches['union_fista']} times in {st_b['refine_rounds']} "
             "refine rounds")
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
    scan_betas = path.beta_path          # held against the resumable path (4k)
    del pb, pbp, path
    torch.cuda.empty_cache()

    # the batched path's refine round at its shape (98 lanes, Cp = 1,024,
    # blocks of 128, 16 steps, 8 sweeps) over 1,024 of the design's
    # columns, the lanes' residuals Gaussian: the union-fista kernel
    # against its plain twin, within 1e-4 of max |bs| (sums in another
    # order than cuBLAS's, through 1,024 dependent steps)
    gu = torch.Generator(device=dev).manual_seed(18)
    ku, Cu, Bu = L - 2, 1024, opts.block_size
    Xu = X[:, :Cu].contiguous()
    Ru = torch.randn((ku, n), generator=gu, device=dev)
    csu = Ru @ Xu
    Bsu = torch.randn((ku, Cu), generator=gu, device=dev) * (
        torch.rand((ku, Cu), generator=gu, device=dev) < 0.05)
    thru = torch.quantile(csu.abs(), 0.9, dim=1, keepdim=True) * (
        0.5 + torch.rand((ku, Cu), generator=gu, device=dev))
    certu = torch.arange(ku, device=dev) % 8 == 7
    uargs = (Xu.T @ Xu, thru, Bsu, csu, certu)
    del Xu, Ru

    def uf_kernel():
        return union_fista.fused_union_fista(*uargs, opts)

    def uf_plain():
        return batched_certify.union_block_fista_plain(*uargs, opts)

    out_u, ref_u = uf_kernel(), uf_plain()
    if not torch.equal(out_u[certu], Bsu[certu]):
        fail("union_fista: a certified lane is not Bs0 bit for bit")
    ms = cuda_ms(uf_kernel, 20)
    pms = cuda_ms(uf_plain, 3)
    # a one-call trace this late in the process may hold no kernel (see
    # phase 3): the device time is then not measured
    _, names, dms = one_call(uf_kernel)
    dms = dms if names else None
    ncb = Cu // Bu
    report("union_fista", "union-fista round", maxdiff(out_u, ref_u),
           1e-4 * float(ref_u.abs().max()), ms, pms,
           f"k={ku}, Cp={Cu}, B={Bu}, {opts.block_iters} steps, 8 sweeps; "
           "device " + ("not measured" if dms is None else f"{dms:.4f} ms"),
           4 * (Cu * Cu + 4 * ku * Cu),
           2 * ku * 8 * ncb * (opts.block_iters * Bu * Bu + Bu * Cu),
           device_ms=dms)
    if not ok:
        fail("union_fista disagrees with its plain twin")
    del uargs, out_u, ref_u, Bsu, csu, thru, certu

    # 4c. time to the 1e-7 gap (bench.py:300-320): a warm single solve with
    # the default options, then the polish of its own output
    lam_t = lam_end * (1.0 + 2e-7)
    tcd.polish_lasso(X, y, tcd.lasso(X, y, lam_end * (1.0 + 1e-7)).x,
                     lam_end * (1.0 + 1e-7))               # warm-up
    reset_counts()
    sol_t, t_single = wall(lambda: tcd.lasso(X, y, lam_t))
    launches_s, reads_s = counts(), dict(host.COUNTS)
    require_launches("lasso", launches_s, ("K1", "K3", "K4", "K5", "BL"))
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
    x_c = sol_t.x                        # held against 4k's solves
    del sol_t, res
    torch.cuda.empty_cache()

    def same_support(name, a, b):
        bad = support_mismatch(a, b, supp_tol)
        log(f"{name}: kernel vs plain support: {int((a != 0).sum())} vs "
            f"{int((b != 0).sum())}, differing "
            f"{int(((a != 0) != (b != 0)).sum())} (above {supp_tol:g}: "
            f"{bad}), max |diff| {maxdiff(a, b):.3e}")
        if bad or not int((a != 0).sum()):
            fail(f"{name}: kernel and plain supports differ above "
                 f"{supp_tol:g} (or the solution is empty)")

    def finite(name, x, length=p):
        if tuple(x.shape) != (length,) or not bool(torch.isfinite(x).all()):
            fail(f"{name}: not a finite vector of {length} coefficients")

    # 4d. sqrt_lasso (bench.py:358-366) and its 1e-7 polish
    tcd.sqrt_lasso(X, y, lam_sq, options=opts_sq, standardize_X=False)
    lam_d = lam_sq * (1.0 + 1e-7)
    reset_counts()
    sol_d, t_d = wall(lambda: tcd.sqrt_lasso(X, y, lam_d, options=opts_sq,
                                             standardize_X=False))
    launches_d, reads_d = counts(), dict(host.COUNTS)
    require_launches("sqrt_lasso", launches_d, ("K1sqrt", "K5"),
                     never=("K3", "K4", "K1", "K1wls"))
    add(launches_d)
    finite("sqrt_lasso", sol_d.x)
    reset_counts()
    sol_dp, t_dp = wall(lambda: tcd.sqrt_lasso(
        X, y, lam_d, options=opts_sq.replace(use_pallas=False),
        standardize_X=False))
    if any(counts().values()):
        fail("use_pallas=False launched a kernel")
    same_support("sqrt_lasso", sol_d.x, sol_dp.x)
    kkt_d, rn_d = tcd.sqrt_lasso_kkt_compensated(X, y, sol_d.x, lam_d)
    log(f"sqrt_lasso: kernels {t_d:.4f} s, plain {t_dp:.3f} s; nnz "
        f"{int((sol_d.x != 0).sum())}, planted support recovered "
        f"{int((sol_d.x[support] != 0).sum())}/{s}; compensated kkt_rel "
        f"{kkt_d:.3e}, |r| {rn_d:.4f}; launches {launches_d}; host reads "
        f"{reads_d['host_reads']} over {reads_d['epochs']} epochs")
    if not kkt_d <= 1e-3:
        fail(f"sqrt_lasso: compensated relative KKT {kkt_d:.3e} above 1e-3")
    tcd.polish_sqrt_lasso(X, y, sol_dp.x, lam_d)                 # warm-up
    reset_counts()
    res_d, t_dpol = wall(lambda: tcd.polish_sqrt_lasso(X, y, sol_d.x, lam_d))
    launches = counts()
    require_launches("sqrt polish", launches, ("K1sqrt_f64", "K5f64"),
                     never=("K3", "K4"))
    add(launches)
    log(f"sqrt polish: {t_dpol:.4f} s; kkt_rel {res_d.kkt_rel:.3e}, "
        f"converged {res_d.converged}, rounds {res_d.rounds}, support "
        f"{res_d.support_size}; launches {launches}; host reads "
        f"{host.COUNTS['host_reads']}")
    if not (res_d.converged and res_d.kkt_rel <= 1e-7):
        fail(f"sqrt polish did not reach kkt_rel 1e-7: {res_d.kkt_rel:.3e}")
    kkt_chk, _ = tcd.sqrt_lasso_kkt_compensated(X, y, res_d.beta, lam_d)
    if not kkt_chk <= 1.1e-7:
        fail(f"the recomputed sqrt certificate is {kkt_chk:.3e} > 1.1e-7")
    x_d = sol_d.x                        # held against 4l's sqrt solve
    del sol_d, sol_dp, res_d
    torch.cuda.empty_cache()

    # 4e. scaled_lasso (bench.py:422, the default options) and its polish
    lam_sc = math.sqrt(2 * math.log(p) / n)
    tcd.scaled_lasso(X, y, lam_sc)                               # warm-up
    reset_counts()
    sol_e, t_e = wall(lambda: tcd.scaled_lasso(X, y, lam_sc * (1.0 + 1e-7)))
    launches_e, reads_e = counts(), dict(host.COUNTS)
    require_launches("scaled_lasso", launches_e, ("K1", "K3", "K4", "K5"))
    add(launches_e)
    finite("scaled_lasso", sol_e.x)
    reset_counts()
    res_e, t_epol = wall(lambda: tcd.polish_scaled_lasso(
        X, y, sol_e.x, lam_sc * (1.0 + 2e-7)))
    launches = counts()
    require_launches("scaled polish", launches, ("K1f64", "K5f64"))
    add(launches)
    log(f"scaled_lasso: {t_e:.4f} s, sigma {float(sol_e.sigma):.4f}, nnz "
        f"{int((sol_e.x != 0).sum())}; launches {launches_e}; host reads "
        f"{reads_e['host_reads']} over {reads_e['epochs']} epochs; polish "
        f"{t_epol:.4f} s: rel gap {res_e.rel_gap:.3e}, sigma rel change "
        f"{res_e.sigma_rel_change:.1e}, sigma {res_e.sigma:.6f}, sigma "
        f"rounds {res_e.sigma_rounds}, rounds {res_e.rounds}, converged "
        f"{res_e.converged}; launches {launches}")
    if not (res_e.converged and res_e.rel_gap <= 1e-7
            and res_e.sigma_rel_change <= 1e-7):
        fail("scaled polish did not reach its 1e-7 fixed point")
    sigma_e = float(sol_e.sigma)          # held against 4k's σ-round trace
    del sol_e, res_e

    # 4f. feasible_lasso at the same level and its polish
    tcd.feasible_lasso(X, y, lam_sc)                             # warm-up
    reset_counts()
    sol_f, t_f = wall(lambda: tcd.feasible_lasso(X, y,
                                                 lam_sc * (1.0 + 1e-7)))
    launches_f, reads_f = counts(), dict(host.COUNTS)
    require_launches("feasible_lasso", launches_f,
                     ("K1", "K3", "K4", "K5", "LD"))
    add(launches_f)
    finite("feasible_lasso", sol_f.x)
    reset_counts()
    res_f, t_fpol = wall(lambda: tcd.polish_feasible_lasso(
        X, y, sol_f.x, lam_sc * (1.0 + 2e-7)))
    launches = counts()
    require_launches("feasible polish", launches, ("K1f64", "K5f64", "LD"))
    add(launches)
    ld_f64_launches = launches["LD"]
    log(f"feasible_lasso: {t_f:.4f} s, nnz {int((sol_f.x != 0).sum())}; "
        f"launches {launches_f}; host reads {reads_f['host_reads']} over "
        f"{reads_f['epochs']} epochs; polish {t_fpol:.4f} s: rel gap "
        f"{res_f.rel_gap:.3e}, loading rel change "
        f"{res_f.loading_rel_change:.1e}, loading rounds "
        f"{res_f.loading_rounds}, rounds {res_f.rounds}, converged "
        f"{res_f.converged}; launches {launches}")
    if not (res_f.converged and res_f.rel_gap <= 1e-7):
        fail("feasible polish did not reach its 1e-7 fixed point")
    x_f = sol_f.x                        # held against 4l's feasible solve
    del sol_f, res_f
    torch.cuda.empty_cache()

    # 4g. one weighted-least-squares solve: K1's wls form, and K3/K4 with
    # the screen off (the engine screens the ls kind only)
    w_g = 0.5 + torch.rand(n, generator=g, device=dev)
    loss_g = tcd.WeightedLSLoss(y, X, w_g)
    lam_g = 0.05 * float(torch.max(torch.abs((w_g * y) @ X)) / n)
    beta0 = torch.zeros(p, device=dev)
    screens = []
    phase_a = check.check_phase_a

    def phase_a_seen(*a, screen):
        screens.append(screen)
        return phase_a(*a, screen=screen)

    tcd.coordinate_descent(beta0, loss_g, tcd.ProxL1(lam_g), opts)  # warm-up
    check.check_phase_a = phase_a_seen
    reset_counts()
    (beta_g, _), t_g = wall(lambda: tcd.coordinate_descent(
        beta0, loss_g, tcd.ProxL1(lam_g * (1.0 + 1e-7)), opts))
    check.check_phase_a = phase_a
    launches_g, reads_g = counts(), dict(host.COUNTS)
    require_launches("wls solve", launches_g, ("K1wls", "K3", "K4"),
                     never=("K1", "K1sqrt"))
    add(launches_g)
    if not screens or any(screens):
        fail(f"the wls solve must call phase A with the screen off: {screens}")
    finite("wls solve", beta_g)
    reset_counts()
    (beta_gp, _), t_gp = wall(lambda: tcd.coordinate_descent(
        beta0, loss_g, tcd.ProxL1(lam_g * (1.0 + 1e-7)), plain))
    if any(counts().values()):
        fail("use_pallas=False launched a kernel")
    same_support("wls solve", beta_g, beta_gp)
    log(f"wls solve: kernels {t_g:.4f} s, plain {t_gp:.3f} s at lam "
        f"{lam_g:.6f}; launches {launches_g}; phase A calls {len(screens)}, "
        f"all with the screen off; host reads {reads_g['host_reads']} over "
        f"{reads_g['epochs']} epochs")

    # 4k. observability and persistence at full width, on the bench problem
    # (utils/checkpoint.py, utils/profiling.py, the engine's count_x)
    t_4k = time.perf_counter()
    ck_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "smoke_checkpoints")
    shutil.rmtree(ck_dir, ignore_errors=True)
    os.makedirs(ck_dir)

    def ck_file(name):
        return os.path.join(ck_dir, name)

    save_s = [0.0, 0]
    save_real = ckpt.save_checkpoint

    def save_timed(path, ck):
        t = time.perf_counter()
        save_real(path, ck)
        save_s[0] += time.perf_counter() - t
        save_s[1] += 1

    # the resumable path at checkpoint_every=1: the scan's trajectory
    ckpt.save_checkpoint = save_timed
    reset_counts()
    pr, t_res = wall(lambda: tcd.lasso_path_resumable(
        X, y, lams, ck_file("every1.npz"), options=opts, standardize_X=False,
        checkpoint_every=1))
    ckpt.save_checkpoint = save_real
    launches_k, reads_k = counts(), dict(host.COUNTS)
    require_launches("resumable path", launches_k,
                     ("K1", "K2", "K3", "K4", "K5"))
    add(launches_k)
    bad = support_mismatch(pr.beta_path, scan_betas, 0.0)
    dmax = (maxdiff(pr.beta_path, scan_betas)
            if tuple(pr.beta_path.shape) == (L, p) else math.inf)
    log(f"lasso_path_resumable ({L} points, checkpoint_every=1): "
        f"{t_res:.3f} s, of it {save_s[0]:.3f} s in {save_s[1]} "
        f"save_checkpoint calls; launches {launches_k}; host reads "
        f"{reads_k['host_reads']} over {reads_k['epochs']} epochs (2 a "
        f"save); vs the scan of 4a: supports differing {bad}, max |dbeta| "
        f"{dmax:.3e} (expected 0)")
    if bad or dmax != 0:
        fail("the resumable path is not bit for bit the scan of 4a")
    del pr

    # an interrupted randomized run (50 points), resumed to 100, against the
    # uninterrupted run: bit for bit, the final checkpoints too
    opts_r = opts.replace(randomize=True)

    def resumable(lam_grid, name):
        return tcd.lasso_path_resumable(X, y, lam_grid, ck_file(name),
                                        options=opts_r, standardize_X=False,
                                        checkpoint_every=10)

    full, t_full = wall(lambda: resumable(lams, "full.npz"))
    resumable(lams[:50], "interrupted.npz")
    ck = tcd.load_checkpoint(ck_file("interrupted.npz"))
    if ck is None or ck.next_index != 50:
        fail("the interrupted run left no checkpoint at point 50")
    tcd.save_checkpoint(ck_file("interrupted.npz"), ck._replace(
        lam_path=np.asarray(lams, ck.lam_path.dtype)))
    resumed, t_resumed = wall(lambda: resumable(lams, "interrupted.npz"))
    ck_a = tcd.load_checkpoint(ck_file("full.npz"))
    ck_b = tcd.load_checkpoint(ck_file("interrupted.npz"))
    differ = [f for f in ("beta_path", "beta_warm", "residuals", "key", "c",
                          "drift", "active", "ws_idx", "ws_ok", "beta_prev",
                          "lam_k", "lam_km1", "next_index")
              if not np.array_equal(getattr(ck_a, f), getattr(ck_b, f))]
    same = bool(torch.equal(full.beta_path, resumed.beta_path))
    log(f"resume (randomize=True, checkpoint_every=10): uninterrupted "
        f"{t_full:.3f} s, resumed half {t_resumed:.3f} s; beta paths bitwise "
        f"equal {same}, max |dbeta| "
        f"{maxdiff(full.beta_path, resumed.beta_path):.3e}; checkpoint fields "
        f"differing {differ}; ws_idx {ck_b.ws_idx.shape}")
    if not same or differ:
        fail("the resumed run is not bit for bit the uninterrupted one")
    del full, resumed, ck, ck_a, ck_b
    shutil.rmtree(ck_dir, ignore_errors=True)

    # the X-traffic report at 4c's level and options, and count_x on / off
    reset_counts()
    rep_x, t_x = wall(lambda: tcd.solve_x_traffic(X, y, lam_t))
    launches_x = counts()
    require_launches("solve_x_traffic", launches_x, ("K1", "K3", "K4", "K5"))
    add(launches_x)
    peak = prof.measured_peak_hbm()
    nnz_c = int((x_c != 0).sum())
    log(f"solve_x_traffic (0.05 lammax, default options): x_bytes "
        f"{rep_x.x_bytes}, dense_equiv_bytes {rep_x.dense_equiv_bytes}, "
        f"epochs {rep_x.epochs}, seconds {rep_x.seconds:.4f} (call "
        f"{t_x:.3f} s), achieved {rep_x.achieved_gbps:.1f} GB/s against the "
        f"measured peak {peak / 1e9:.1f} GB/s; nnz {rep_x.nnz} (lasso of 4c: "
        f"{nnz_c}); launches of its three solves {launches_x}")
    if rep_x.nnz != nnz_c:
        fail("solve_x_traffic and the lasso of 4c differ in support size")
    if rep_x.x_bytes < n * p * 4:
        fail(f"solve_x_traffic counted {rep_x.x_bytes} B, less than one read "
             f"of the design ({n * p * 4} B)")
    if rep_x.achieved_gbps * 1e9 > 1.05 * peak:
        fail("solve_x_traffic claims more than 1.05 x the measured peak")
    dflt = tcd.CDOptions()

    def solve_blk(count):
        prob_x = block_cd.build_blocked("ls", dflt, torch.ones(p, device=dev),
                                        X=X, y=y)
        return block_cd.solve_blocked(
            "ls", dflt, prob_x, lam_t, torch.zeros_like(prob_x.lamw),
            torch.Generator().manual_seed(0), count_x=count)

    seen = []
    for count in (False, True):
        reset_counts()
        out = solve_blk(count)
        seen.append((out[0] if count else out, counts(),
                     host.COUNTS["host_reads"], out[1] if count else None))
    (st0, l0, r0, _), (st1, l1, r1, xe) = seen
    log(f"count_x off / on: beta bitwise equal "
        f"{bool(torch.equal(st0.beta, st1.beta))}; launches equal {l0 == l1} "
        f"({l1}); host reads {r0} / {r1}; count {xe * 4} B (report "
        f"{rep_x.x_bytes})")
    if not (torch.equal(st0.beta, st1.beta) and l0 == l1
            and 0 <= r1 - r0 <= 1 and xe * 4 == rep_x.x_bytes):
        fail("count_x changed the solve, its launches or its count, or added "
             "more than one host read")
    del st0, st1, seen
    torch.cuda.empty_cache()

    # the per-epoch trace at the same level: its full epochs run the plain
    # check (no options, as in the JAX package), its active epochs K1
    reset_counts()
    (b_tr, tr), t_tr = wall(lambda: tcd.solve_with_trace(X, y, lam_t))
    launches_tr = counts()
    add(launches_tr)
    bad = support_mismatch(b_tr, x_c, supp_tol)
    log(f"solve_with_trace: {t_tr:.3f} s, {len(tr.max_h)} epochs, last max_h "
        f"{tr.max_h[-1]:.3e}, last certificate (gap) {tr.certificate[-1]:.3e}"
        f", nnz {tr.nnz[-1]}; launches {launches_tr}; vs the lasso of 4c: "
        f"support differing above {supp_tol:g} {bad}, max |diff| "
        f"{maxdiff(b_tr, x_c):.3e}")
    if bad or not launches_tr["K1"]:
        fail("solve_with_trace: another support than lasso's, or K1 idle")

    # the card's streaming peak and K1's roofline at the bench shape
    sheet = prof.H100_HBM_BYTES_PER_S
    in_range = 0.5 * sheet <= peak <= 1.05 * sheet
    log(f"measured_peak_hbm: {peak / 1e9:.1f} GB/s = "
        f"{peak / sheet:.3f} of the data sheet's {sheet / 1e9:.0f} GB/s "
        f"({card})")
    if not in_range:
        fail("the measured peak is outside 0.5-1.05 x the data sheet's rate")
    for rf, it in zip(tcd.pass_roofline_multi(n, p, iters_list=(16, 1)),
                      (16, 1)):
        log(f"pass_roofline (n={n}, p={p}, iters {it}): "
            f"{rf.seconds_per_pass * 1e3:.4f} ms a pass (slope "
            f"{rf.slope_seconds_per_pass * 1e3:.4f} ms), "
            f"{rf.bytes_per_pass} B, {rf.achieved_gbps:.1f} GB/s, "
            f"{rf.fraction_of_roofline:.3f} of the data sheet, "
            f"{rf.fraction_of_measured_peak:.3f} of the measured peak "
            f"({rf.measured_peak_gbps:.1f} GB/s), {rf.device_kind}")
        if not rf.fraction_of_measured_peak <= 1.05:
            fail("pass_roofline: above 1.05 of the measured peak")
    torch.cuda.empty_cache()

    # the per-σ-round trace at 4e's level
    reset_counts()
    (sol_k, str_k), t_sk = wall(lambda: tcd.scaled_lasso_with_trace(
        X, y, lam_sc * (1.0 + 1e-7)))
    launches_sk = counts()
    add(launches_sk)
    rel_sig = abs(float(sol_k.sigma) - sigma_e) / sigma_e
    log(f"scaled_lasso_with_trace: {t_sk:.3f} s, {len(str_k.sigma)} rounds, "
        f"sigma {[round(v, 6) for v in str_k.sigma.tolist()]}, rel change "
        f"{str_k.rel_change[-1]:.2e}; sigma {float(sol_k.sigma):.6f} vs "
        f"scaled_lasso's {sigma_e:.6f}: relative {rel_sig:.2e} (tol 1e-06); "
        f"launches {launches_sk}")
    if not rel_sig <= 1e-6:
        fail("scaled_lasso_with_trace: sigma apart from scaled_lasso's")
    del sol_k, b_tr

    # debug_nans at a small shape: a NaN in r raises out of K5 and out of K1;
    # a clean lasso passes; the mode is off afterwards
    gs_ = torch.Generator(device=dev).manual_seed(3)
    Xs = torch.randn((2000, 4096), generator=gs_, device=dev)
    ys = Xs[:, :8].sum(dim=1) + torch.randn(2000, generator=gs_, device=dev)
    prob_s = block_cd.build_blocked("ls", opts, torch.ones(4096, device=dev),
                                    X=Xs, y=ys)
    nbs = prob_s.lamw.shape[0]
    r_nan = ys.clone()
    r_nan[7] = float("nan")
    caught = []
    for name, fn in (
            ("K5", lambda: gs.fused_gradient_sweep(prob_s.Xwb, r_nan)),
            ("K1", lambda: active_pass.fused_active_pass(
                prob_s, torch.zeros_like(prob_s.lamw), r_nan,
                torch.ones(nbs, dtype=torch.bool, device=dev), 0.1, 2000.0,
                torch.arange(nbs, device=dev), torch.arange(128, device=dev),
                inner="ista"))):
        try:
            with tcd.debug_nans():
                fn()
        except FloatingPointError:
            caught.append(name)
    with tcd.debug_nans():
        sol_s = tcd.lasso(Xs, ys, 0.1)
    off = not _build.NAN_CHECK and _get_current_dispatch_mode() is None
    log(f"debug_nans: FloatingPointError out of {caught}; a clean lasso "
        f"inside the mode: nnz {int((sol_s.x != 0).sum())}; the mode off "
        f"afterwards {off}")
    if caught != ["K5", "K1"] or not off:
        fail("debug_nans missed a NaN or stayed on")
    del Xs, ys, prob_s, r_nan, sol_s
    log(f"phase 4k (h's group trace apart): "
        f"{time.perf_counter() - t_4k:.1f} s")

    # 4l. the multi-device tiers (parallel/): (a) a world of one rank on
    # NCCL at full width, each run in 4a-4f's supports; (b) two Gloo ranks
    # spawned on this one card (time-sliced: a correctness check, not a
    # scaling measurement)
    del loss_g, beta_g, beta_gp, w_g, beta0
    torch.cuda.empty_cache()
    t_4l = time.perf_counter()
    import torch.distributed as dist
    from coordinatedescent_jl_tpu_torch import parallel as par
    from coordinatedescent_jl_tpu_torch.parallel import distributed as pdist

    pdist.initialize_distributed(backend="nccl", store=dist.HashStore(),
                                 num_processes=1, process_id=0, timeout=600)
    fmesh = pdist.feature_mesh()
    # NCCL makes its communicator at the first collective: not in a run's time
    dist.all_reduce(torch.zeros(1, device=dev),
                    group=fmesh.get_group("feature"))
    l_times = {}

    def run_l(name, fn, need, never=()):
        reset_counts()
        out, t = wall(fn)
        launches = counts()
        require_launches(name, launches, need, never)
        add(launches)
        l_times[name] = t
        log(f"4l(a) {name}: {t:.3f} s on {card}; launches {launches}; host "
            f"reads {host.COUNTS['host_reads']} over "
            f"{host.COUNTS['epochs']} epochs")
        return out

    def in_support(name, a, b, tol=supp_tol):
        bad = support_mismatch(a, b, tol)
        d = maxdiff(a, b)
        log(f"4l {name}: supports {int((a != 0).sum())} vs "
            f"{int((b != 0).sum())}, differing above {tol:g}: {bad}, max "
            f"|diff| {d:.3e}")
        if bad or tuple(a.shape) != tuple(b.shape):
            fail(f"4l {name}: another support than the single-device run's")
        return d

    k_ls = ("K1", "K3", "K4", "K5")
    sol_l = run_l("lasso_sharded", lambda: par.lasso_sharded(X, y, lam_t,
                                                             fmesh), k_ls)
    d = in_support("(a) lasso_sharded vs 4c", sol_l.x, x_c)
    gap_l, primal_l = tcd.lasso_duality_gap_f64(X, y, sol_l.x, lam_t)
    log(f"4l(a) lasso_sharded: rel gap {gap_l / primal_l:.3e} (tol 1e-5)")
    if not (d <= 1e-4 and gap_l / primal_l <= 1e-5):
        fail("4l lasso_sharded: a coordinate 1e-4 from 4c's or gap > 1e-5")
    del sol_l
    path_l = run_l("lasso_path_sharded (scan)", lambda: par.lasso_path_sharded(
        X, y, lams, fmesh, options=opts, standardize_X=False, path_batch=0),
        k_ls)
    in_support("(a) path scan vs 4a", path_l.beta_path, scan_betas)
    del path_l
    st_l = {}
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        path_l = run_l("lasso_path_sharded (batched)",
                       lambda: par.lasso_path_sharded(
                           X, y, lams, fmesh, options=opts,
                           standardize_X=False, path_batch=128,
                           coarse_stride=L - 1, stats=st_l), k_ls)
    fell = [str(w.message) for w in wl
            if issubclass(w.category, RuntimeWarning)]
    log(f"4l(a) batched path stats {st_l}")
    if fell or not st_l.get("batched_certified"):
        fail(f"4l: the sharded batched path fell back: {st_l} {fell}")
    in_support("(a) path batched vs 4a", path_l.beta_path, scan_betas)
    del path_l
    sol_l = run_l("sqrt_lasso_sharded", lambda: par.sqrt_lasso_sharded(
        X, y, lam_d, fmesh, options=opts_sq), ("K1sqrt", "K5"),
        never=("K3", "K4"))
    in_support("(a) sqrt_lasso_sharded vs 4d", sol_l.x, x_d)
    sol_l = run_l("scaled_lasso_sharded", lambda: par.scaled_lasso_sharded(
        X, y, lam_sc * (1.0 + 1e-7), fmesh), k_ls)
    rel_s = abs(float(sol_l.sigma) - sigma_e) / sigma_e
    log(f"4l(a) scaled_lasso_sharded: sigma {float(sol_l.sigma):.6f} vs 4e's "
        f"{sigma_e:.6f}: relative {rel_s:.3e} (tol 1e-6)")
    if not rel_s <= 1e-6:
        fail("4l scaled_lasso_sharded: sigma more than 1e-6 from 4e's")
    sol_l = run_l("feasible_lasso_sharded", lambda: par.feasible_lasso_sharded(
        X, y, lam_sc * (1.0 + 1e-7), fmesh), k_ls)
    in_support("(a) feasible_lasso_sharded vs 4f", sol_l.x, x_f)
    b_tr, tr_l = run_l("lasso_sharded_with_trace",
                       lambda: tcd.lasso_sharded_with_trace(X, y, lam_t,
                                                            fmesh), k_ls)
    log(f"4l(a) trace: {len(tr_l.max_h)} epochs, last max_h "
        f"{tr_l.max_h[-1]:.3e}, last gap {tr_l.certificate[-1]:.3e}")
    in_support("(a) trace vs 4c", b_tr, x_c)
    del sol_l, b_tr
    # the resumable sharded path: 20 points, interrupted at 10, resumed
    os.makedirs(ck_dir, exist_ok=True)
    lams20 = lams[:20]
    p_full = run_l("lasso_path_resumable_sharded (20 points)",
                   lambda: tcd.lasso_path_resumable_sharded(
                       X, y, lams20, ck_file("sh_full.npz"), fmesh,
                       options=opts, standardize_X=False), k_ls)
    tcd.lasso_path_resumable_sharded(X, y, lams20[:10], ck_file("sh_int.npz"),
                                     fmesh, options=opts, standardize_X=False)
    ck_i = tcd.load_sharded_checkpoint(ck_file("sh_int.npz"))
    tcd.save_sharded_checkpoint(ck_file("sh_int.npz"), ck_i._replace(
        lam_path=np.asarray(lams20, ck_i.lam_path.dtype)))
    p_res, t_r = wall(lambda: tcd.lasso_path_resumable_sharded(
        X, y, lams20, ck_file("sh_int.npz"), fmesh, options=opts,
        standardize_X=False))
    c_f = tcd.load_sharded_checkpoint(ck_file("sh_full.npz"))
    c_r = tcd.load_sharded_checkpoint(ck_file("sh_int.npz"))
    differ = [f for f in c_f._fields
              if not np.array_equal(getattr(c_f, f), getattr(c_r, f))]
    same_path = torch.equal(p_full.beta_path, p_res.beta_path)
    log(f"4l(a) resumed half: {t_r:.3f} s on {card}; bitwise {same_path}, "
        f"checkpoint fields differing {differ}")
    if not same_path or differ:
        fail("4l: the resumed sharded path is not the uninterrupted run")
    in_support("(a) resumable sharded vs 4a", p_full.beta_path,
               scan_betas[:20])
    del p_full, p_res
    shutil.rmtree(ck_dir, ignore_errors=True)

    # (b) two Gloo ranks on this card, at p = 20,000 (the cut keeps the row
    # tier's plain per-coordinate visits in the phase's time)
    del X, y, support, beta_true
    torch.cuda.empty_cache()
    bpb = bench_problem(dev, p=WORLD_B_P, seed=0)
    lam_b = 0.05 * bpb.lammax
    lam_row = 0.2 * bpb.lammax
    lams_b = [float(v) for v in bpb.lams[:20]]
    lams4 = [float(v) for v in bpb.lams[::33]]
    omesh = pdist.obs_mesh()
    ref_b = dict(
        lasso=par.lasso_sharded(bpb.X, bpb.y, lam_b, fmesh,
                                options=bpb.opts).x,
        path=par.lasso_path_sharded(bpb.X, bpb.y, lams_b, fmesh,
                                    options=bpb.opts, standardize_X=False,
                                    path_batch=0).beta_path,
        row=par.lasso_row_sharded(bpb.X, bpb.y, lam_row, omesh,
                                  options=bpb.opts).x,
        batch=torch.stack([tcd.lasso(bpb.X, bpb.y, v, options=bpb.opts).x
                           for v in lams4]))
    del bpb
    torch.cuda.empty_cache()
    try:
        (ranks, t_b) = wall(lambda: pdist.World(
            _world_b_rank, 2, (WORLD_B_P, lam_b, lam_row, lams_b, lams4),
            backend="gloo", timeout=600).wait())
    except (OSError, RuntimeError) as e:
        fail(f"4l(b): a rank of the two-rank world failed: {e}")
    for name in ("lasso", "path", "row", "batch"):
        for r, out in enumerate(ranks):
            got = torch.as_tensor(out[name]).to(dev)
            if not torch.equal(got, torch.as_tensor(ranks[0][name]).to(dev)):
                fail(f"4l(b) {name}: rank {r}'s result is not rank 0's")
        in_support(f"(b) {name} vs the world of one",
                   torch.as_tensor(ranks[0][name]).to(dev), ref_b[name])
    d_batch = maxdiff(torch.as_tensor(ranks[0]["batch"]).to(dev),
                      ref_b["batch"])
    log(f"4l(b) lasso_lambda_batch vs single-device lasso at 4 values: max "
        f"|diff| {d_batch:.3e} (tol 1e-6)")
    if not d_batch <= 1e-6:
        fail("4l(b): lasso_lambda_batch is not the single-device lasso")
    # the kernels each run must launch in every rank: the feature-sharded
    # runs K1 and K5, the row tier K5 (its local gradient), the λ batch K1
    need_b = dict(lasso=("K1", "K5"), path=("K1", "K5"), row=("K5",),
                  batch=("K1",))
    for r, out in enumerate(ranks):
        log(f"4l(b) rank {r} on {card}: times {out['times']}; launches "
            f"{out['launches']}; union all-reduce bytes (the (C, n) set) "
            f"{out['union_bytes']}")
        for name, keys in need_b.items():
            missing = [k for k in keys if not out["launches"][name][k]]
            if missing:
                fail(f"4l(b) rank {r} {name}: {missing} not launched")
            add(out["launches"][name])
    log(f"4l(b): two Gloo ranks on {card}: {t_b:.1f} s wall (spawn "
        f"included)")
    dist.destroy_process_group()
    log(f"phase 4l (h's group run apart) on {card}: "
        f"{time.perf_counter() - t_4l:.1f} s; times {l_times}")

    # 4m. the two paths bench.py runs that no earlier phase does, at its
    # shapes, on a world of one (NCCL): the feature-sharded p = 1M solve
    # and path (bench.py:1098-1193) and the row tier at 50,000 x 2,000
    # (bench.py:1062-1091)
    t_4m = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    pdist.initialize_distributed(backend="nccl", store=dist.HashStore(),
                                 num_processes=1, process_id=0, timeout=600)
    fmesh = pdist.feature_mesh()
    dist.all_reduce(torch.zeros(1, device=dev),
                    group=fmesh.get_group("feature"))
    X1, y1, lam1 = pbench.p1m_problem(dev)
    n1, p1 = X1.shape
    nb_m = -(-p1 // B)
    opts1 = tcd.CDOptions(opt_tol=pbench.OPT_TOL, randomize=False)
    m_launches = dict.fromkeys(counts(), 0)
    # the p = 1M runs' launches at the kernel rows' shapes and routes alone
    # (the wrappers' counts by shape): K5 over all nb_m blocks of n1 rows,
    # K1 (ls, f32) at n1 rows on its cluster route, K3/K4 at nb_m rows on
    # the cooperative route
    p1m_launches = dict.fromkeys(("K5_p1m", "K1_n1000", "K3_p1m", "K4_p1m"),
                                 0)

    def run_m(name, fn, need, p1m=True):
        reset_counts()
        out, t = wall(fn)
        launches = counts()
        require_launches(name, launches, need)
        add(launches)
        shaped = {}
        if p1m:
            for k, v in launches.items():
                m_launches[k] += v
            shaped = {
                "K5_p1m": gs.LAUNCHES_DENSE_SHAPE[nb_m, n1],
                "K1_n1000": active_pass.LAUNCHES_SHAPE["ls", False, n1, True],
                "K3_p1m": check.LAUNCHES_SHAPE["a", nb_m, False],
                "K4_p1m": check.LAUNCHES_SHAPE["b", nb_m, False]}
            for k, v in shaped.items():
                p1m_launches[k] += v
        log(f"4m {name}: {t:.3f} s on {card}; launches {launches}; at the "
            f"p = 1M rows' shapes {shaped}; host reads "
            f"{host.COUNTS['host_reads']} over {host.COUNTS['epochs']} "
            f"epochs")
        return out

    sol1 = run_m(f"lasso_sharded (n = {n1}, p = {p1})",
                 lambda: par.lasso_sharded(X1, y1, lam1, fmesh,
                                           options=opts1), k_ls)
    gap1, primal1 = tcd.lasso_duality_gap_f64(X1, y1, sol1.x, lam1)
    # the single-device lasso on the same X: phase 3's solve
    bad = support_mismatch(sol1.x, x_p1m, supp_tol)
    d1 = maxdiff(sol1.x, x_p1m)
    log(f"4m p = {p1}: rel gap {gap1 / primal1:.3e} (tol "
        f"{100 * pbench.OPT_TOL:.0e}); nnz {int((sol1.x != 0).sum())}; vs the "
        f"single-device lasso of phase 3: nnz {int((x_p1m != 0).sum())}, "
        f"support differing above {supp_tol:g} {bad}, max |diff| {d1:.3e} "
        f"(tol 1e-4)")
    if not gap1 / primal1 < 100 * pbench.OPT_TOL:
        fail("4m: the p = 1M sharded solve's relative gap is not below "
             "100 opt_tol")
    if bad or not d1 <= 1e-4:
        fail("4m: the p = 1M sharded solve is not the single-device lasso")
    del x_p1m
    lams1 = np.asarray(pbench.lam_max(X1, y1)
                       * np.logspace(-0.05, -1.3, 20), np.float32)
    st_m = {}
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        path1 = run_m("lasso_path_sharded (20 points, batched)",
                      lambda: par.lasso_path_sharded(
                          X1, y1, lams1, fmesh, options=opts1,
                          standardize_X=False, path_batch=20,
                          coarse_stride=19, stats=st_m), k_ls)
    fell = [str(w.message) for w in wl
            if issubclass(w.category, RuntimeWarning)]
    log(f"4m path stats {st_m}; nnz at its end "
        f"{int((path1.beta_path[-1] != 0).sum())}")
    if fell or not st_m.get("batched_certified"):
        fail(f"4m: the p = 1M batched path fell back: {st_m} {fell}")
    if (tuple(path1.beta_path.shape) != (20, p1)
            or not bool(torch.isfinite(path1.beta_path).all())):
        fail("4m: the p = 1M path is not 20 finite points")
    del path1

    del sol1, X1, y1
    torch.cuda.empty_cache()

    missing = [k for k, v in p1m_launches.items() if not v]
    if missing:
        fail(f"4m: the p = 1M runs never launched {missing} at their rows' "
             f"shapes and routes: {p1m_launches}")

    # the row tier at bench.py's shape (its launches stay out of the p = 1M
    # rows' counts)
    Xr, yr, lam_r = pbench.row_problem(dev)
    sol_r = run_m(f"lasso_row_sharded (n = {Xr.shape[0]}, p = {Xr.shape[1]})",
                  lambda: par.lasso_row_sharded(Xr, yr, lam_r,
                                                pdist.obs_mesh(),
                                                options=opts1), ("K5",),
                  p1m=False)
    ref_r = tcd.lasso(Xr, yr, lam_r, options=opts1)
    bad = support_mismatch(sol_r.x, ref_r.x, supp_tol)
    d_r = maxdiff(sol_r.x, ref_r.x)
    log(f"4m row tier vs the single-device lasso: nnz "
        f"{int((sol_r.x != 0).sum())} vs {int((ref_r.x != 0).sum())}, "
        f"support differing above {supp_tol:g} {bad}, max |diff| {d_r:.3e} "
        f"(tol 1e-4)")
    if bad or not d_r <= 1e-4:
        fail("4m: the row tier is not the single-device lasso")
    del Xr, yr, sol_r, ref_r
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"phase 4m on {card}: {time.perf_counter() - t_4m:.1f} s; peak "
        f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
        f"GiB; launches of the p = 1M runs {m_launches}, of them at the "
        f"kernel rows' shapes {p1m_launches}")

    # 4h. the group Lasso (bench.py:613-672): warm solves at
    # lam (1 + 1e-7 rep), the faster of two, then the plain run and the
    # polish of the last solution
    gp = group_bench_problem(dev)
    Xg, yg, Gg = gp.X, gp.y, gp.G
    tcd.group_lasso(Xg, yg, gp.lam, Gg, options=gp.opts)          # warm-up
    t_h = math.inf
    for rep in range(2):
        lam_h = gp.lam * (1.0 + 1e-7 * (rep + 1))
        reset_counts()
        sol_h, t = wall(lambda: tcd.group_lasso(Xg, yg, lam_h, Gg,
                                                options=gp.opts))
        t_h = min(t_h, t)
    launches_h, reads_h = counts(), dict(host.COUNTS)
    require_launches("group_lasso", launches_h, ("K5", "GP", "BL"),
                     never=[k for k in launches_h
                            if k not in ("K5", "GP", "BL")])
    add(launches_h)
    finite("group_lasso", sol_h.x, Xg.shape[1])
    # one GP launch an active pass: the engine's passes counted apart
    passes = [0]
    pass_fn = group_cd._group_active_pass

    def counted_pass(*a, **kw):
        passes[0] += 1
        return pass_fn(*a, **kw)

    group_cd._group_active_pass = counted_pass
    try:
        reset_counts()
        tcd.group_lasso(Xg, yg, lam_h, Gg, options=gp.opts)
    finally:
        group_cd._group_active_pass = pass_fn
    n_gp = counts()["GP"]
    log(f"group_lasso: {passes[0]} active passes, GP launched {n_gp} times")
    if not passes[0] or n_gp != passes[0]:
        fail(f"group_lasso: GP launched {n_gp} times in {passes[0]} active "
             "passes")
    reset_counts()
    sol_hp, t_hp = wall(lambda: tcd.group_lasso(
        Xg, yg, lam_h, Gg, options=gp.opts.replace(use_pallas=False)))
    if any(counts().values()):
        fail("use_pallas=False launched a kernel")
    xg, xgp = sol_h.x.reshape(-1, Gg), sol_hp.x.reshape(-1, Gg)
    grp = torch.nonzero(torch.any(xg != 0, dim=1)).flatten()
    grp_p = torch.nonzero(torch.any(xgp != 0, dim=1)).flatten()
    dh = maxdiff(sol_h.x, sol_hp.x)
    planted = int(torch.isin(gp.groups, grp).sum())
    kkt_h, _ = tcd.group_lasso_kkt_compensated(Xg, yg, sol_h.x, lam_h, Gg)
    log(f"group_lasso (n={Xg.shape[0]}, p={Xg.shape[1]}, G={Gg}): kernels "
        f"{t_h:.4f} s (min of 2), plain {t_hp:.4f} s at lam {lam_h:.6f}; "
        f"groups {grp.numel()} vs {grp_p.numel()} (planted recovered "
        f"{planted}/{gp.groups.numel()}), max |diff| {dh:.3e} (tol "
        f"1.0e-04); compensated kkt_rel {kkt_h:.3e}; launches {launches_h}; "
        f"host reads {reads_h['host_reads']} over {reads_h['epochs']} epochs")
    if not (torch.equal(grp, grp_p) and grp.numel() and dh <= 1e-4):
        fail("group_lasso: kernel and plain runs differ in group support or "
             "by more than 1e-4")
    if not kkt_h <= 1e-3:
        fail(f"group_lasso: compensated relative KKT {kkt_h:.3e} above 1e-3")
    del sol_hp
    # one active pass at the cell's shape (n = 10,000, B = 128, G = 8) from
    # 0.9 x the solution: GP against its plain twin (the same groups, within
    # 1e-5 of max |beta| and of max |r|), both times and its bound
    ng_h = -(-Xg.shape[1] // Gg)
    prob_h = group_cd._build_group_problem(
        Xg, yg, torch.ones((ng_h,), device=dev), Gg)
    nb_h, B_h = prob_h.valid.shape
    beta_h = torch.nn.functional.pad(0.9 * sol_h.x, (0, nb_h * B_h
                                                     - Xg.shape[1]))
    st_h = group_cd._group_init(prob_h, beta_h.reshape(nb_h, B_h), None)
    coefs_h = fista_momentum(gp.opts.block_iters, torch.float32)
    n_h = float(Xg.shape[0])
    order_h = torch.arange(nb_h, device=dev)

    def gp_kernel():
        return group_pass.fused_group_pass(prob_h, st_h.beta, st_h.r,
                                           st_h.active, lam_h, n_h, order_h,
                                           coefs_h)

    def gp_plain():
        s2, mh = group_cd._group_active_pass_plain(prob_h, st_h, lam_h, n_h,
                                                   False, coefs_h)
        return s2.beta, s2.r, mh

    (bk_h, rk_h, mk_h), (bp_h, rp_h, mp_h) = gp_kernel(), gp_plain()
    a_h = int(host.item(torch.sum(st_h.active)))
    zk = torch.any(bk_h.reshape(-1, Gg) != 0, dim=1)
    zp = torch.any(bp_h.reshape(-1, Gg) != 0, dim=1)
    err_b = maxdiff(bk_h, bp_h) / max(float(bp_h.abs().max()), 1e-30)
    err_r = maxdiff(rk_h, rp_h) / max(float(rp_h.abs().max()), 1e-30)
    ms = cuda_ms(gp_kernel, 20)
    pms = cuda_ms(gp_plain, 3)
    _, names, dms = one_call(gp_kernel)
    dms = dms if names else None
    it_h = len(coefs_h)
    report("GP", "group pass", max(err_b, err_r), 1e-5, ms, pms,
           f"n={Xg.shape[0]}, B={B_h}, G={Gg}, {a_h} of {nb_h} blocks "
           f"active, {it_h} steps; relative to max |beta|, max |r|; maxh "
           f"{float(mk_h):.4e} vs {float(mp_h):.4e}; device (with the "
           "threshold table's three elementwise ops) "
           + ("not measured" if dms is None else f"{dms:.4f} ms"),
           4 * (a_h * (Xg.shape[0] * B_h + B_h * B_h) + 2 * nb_h * B_h
                + 2 * Xg.shape[0]),
           a_h * (4 * Xg.shape[0] * B_h + 2 * (it_h + 1) * B_h * B_h),
           device_ms=dms)
    if not ok or not torch.equal(zk, zp):
        fail("group_pass disagrees with its plain twin")
    del prob_h, st_h, beta_h, bk_h, rk_h, bp_h, rp_h
    torch.cuda.empty_cache()
    # 4k, inside 4h: the per-epoch group trace on 4h's problem (K5 its full
    # sweeps and certificates)
    reset_counts()
    (b_gt, tr_g), t_gt = wall(lambda: tcd.group_solve_with_trace(
        Xg, yg, lam_h, Gg, options=gp.opts))
    launches_gt = counts()
    require_launches("group_solve_with_trace", launches_gt, ("K5", "GP"),
                     never=[k for k in launches_gt
                            if k not in ("K5", "GP", "BL")])
    add(launches_gt)
    grp_t = torch.nonzero(torch.any(b_gt.reshape(-1, Gg) != 0,
                                    dim=1)).flatten()
    log(f"group_solve_with_trace: {t_gt:.3f} s, {len(tr_g.max_h)} epochs, "
        f"last max_h {tr_g.max_h[-1]:.3e}, last certificate "
        f"{tr_g.certificate[-1]:.3e}; groups {grp_t.numel()} vs group_lasso's "
        f"{grp.numel()}; launches {launches_gt}")
    if not torch.equal(grp_t, grp):
        fail("group_solve_with_trace: another group support than "
             "group_lasso's")
    del b_gt
    # 4l, inside 4h: the sharded group Lasso on a world of one (NCCL)
    pdist.initialize_distributed(backend="nccl", store=dist.HashStore(),
                                 num_processes=1, process_id=0, timeout=600)
    reset_counts()
    sol_gl, t_gl = wall(lambda: par.group_lasso_sharded(
        Xg, yg, lam_h, Gg, pdist.feature_mesh(), options=gp.opts))
    launches_gl = counts()
    require_launches("group_lasso_sharded", launches_gl, ("K5", "GP"),
                     never=[k for k in launches_gl
                            if k not in ("K5", "GP", "BL")])
    add(launches_gl)
    grp_l = torch.nonzero(torch.any(sol_gl.x.reshape(-1, Gg) != 0,
                                    dim=1)).flatten()
    log(f"4l(a) group_lasso_sharded: {t_gl:.4f} s on {card}; groups "
        f"{grp_l.numel()} vs group_lasso's {grp.numel()}, max |diff| "
        f"{maxdiff(sol_gl.x, sol_h.x):.3e}; launches {launches_gl}")
    dist.destroy_process_group()
    if not torch.equal(grp_l, grp):
        fail("4l group_lasso_sharded: another group support than 4h's")
    del sol_gl
    tcd.polish_group_lasso(Xg, yg, sol_h.x, gp.lam, Gg)          # warm-up
    reset_counts()
    res_h, t_hpol = wall(lambda: tcd.polish_group_lasso(Xg, yg, sol_h.x,
                                                        lam_h, Gg))
    launches = counts()
    require_launches("group polish", launches, ("K5f64",))
    add(launches)
    log(f"group polish: {t_hpol:.4f} s; kkt_rel {res_h.kkt_rel:.3e}, "
        f"converged {res_h.converged}, rounds {res_h.rounds}, support "
        f"groups {res_h.support_groups}; launches {launches}; host reads "
        f"{host.COUNTS['host_reads']}")
    if not (res_h.converged and res_h.kkt_rel <= 1e-7):
        fail(f"group polish did not reach kkt_rel 1e-7: {res_h.kkt_rel:.3e}")
    del gp, Xg, yg, sol_h, res_h
    torch.cuda.empty_cache()

    # 4i. the symmetric solve: covariance thresholding at p = 128,
    # min ½‖M − S‖_F² + λ‖M‖_{1,off} as the packed quadratic
    # ½ v'Dv − (Ds)'v (D: 1 on the diagonal, 2 off it; off-diagonal
    # penalty weight 2)
    ps, lam_i = 128, 0.15
    A = torch.randn((ps, 40), generator=g, device=dev)
    S = A @ A.T / 40.0
    ij = tcd.sym_indices(ps).to(dev)
    off = (ij[:, 0] != ij[:, 1]).float()
    dq = 1.0 + off
    loss_i = tcd.QuadraticLoss(torch.diag(dq), -(dq * tcd.sym_pack(S)))
    reset_counts()
    (M, _), t_i = wall(lambda: tcd.symmetric_coordinate_descent(
        torch.zeros((ps, ps), device=dev), loss_i,
        tcd.ProxL1(lam_i, 2.0 * off), tcd.CDOptions(opt_tol=1e-7,
                                                    randomize=False)))
    if any(counts().values()):
        fail("the symmetric solve (quad kind) launched a kernel")
    want = torch.sign(S) * torch.clamp_min(S.abs() - lam_i, 0.0)
    want.fill_diagonal_(0.0)
    want += torch.diag(torch.diagonal(S))
    err_i = maxdiff(M, want)
    log(f"symmetric solve (p={ps}, q={ij.shape[0]}): {t_i:.4f} s; max "
        f"|M - closed form| {err_i:.3e} (tol 1.0e-05); symmetric "
        f"{bool(torch.equal(M, M.T))}; nonzero off-diagonal pairs "
        f"{int((M != 0).sum() - ps) // 2}; host reads "
        f"{host.COUNTS['host_reads']} over {host.COUNTS['epochs']} epochs")
    if not (M.is_cuda and torch.equal(M, M.T) and err_i <= 1e-5):
        fail("the symmetric solve missed its closed form")

    # 4j. the varying-coefficient suite at bench.py's configuration
    # (bench.py:480-611): the scan (first call, then the faster of two at
    # lam0 (1 + 1e-7 rep)), a plain run on its first 100 points, the
    # batched grid, locpoly, and the LOO-CV batched and sequential
    del M, S, A, loss_i
    torch.cuda.empty_cache()
    Xv, zv, yv, zgv = vp.X, vp.z, vp.y, vp.zgrid
    Lv, ep_v = len(zgv), Xv.shape[1] * (vp.degree + 1)

    def vc_l1(lam, zgrid=zgv, **kw):
        return tcd.locpolyl1(Xv, zv, yv, zgrid, vp.degree, kern_v, lam, **kw)

    def vc_finite(name, a, shape):
        if tuple(a.shape) != shape or not bool(torch.isfinite(a).all()):
            fail(f"{name}: not a finite {shape} result")

    reset_counts()
    (o_s, r_s), t_sf = wall(lambda: vc_l1(vp.lam0, grid_batch=0))
    reads_sf = dict(host.COUNTS)
    t_s = math.inf
    for rep in range(2):
        reset_counts()
        _, t = wall(lambda: vc_l1(vp.lam0 * (1.0 + 1e-7 * (rep + 1)),
                                  grid_batch=0))
        t_s = min(t_s, t)
    launches_j, reads_j = counts(), dict(host.COUNTS)
    require_launches("varying-coefficient scan", launches_j,
                     ("K1wls", "K3", "K4", "K5"),
                     never=("K2", "K1", "K1sqrt", "K1f64", "K5f64"))
    add(launches_j)
    vc_finite("locpolyl1 scan", o_s, (ep_v, Lv))
    vc_finite("locpolyl1 scan refits", r_s, (ep_v, Lv))
    log(f"locpolyl1 scan (n={nv}, p={Xv.shape[1]}, degree {vp.degree}, "
        f"{Lv} points): first {t_sf:.4f} s, warm {t_s:.4f} s (min of 2); "
        f"launches {launches_j}; host reads {reads_j['host_reads']} over "
        f"{reads_j['epochs']} epochs ({reads_sf['epochs']} in the first "
        f"call); nnz per point {float((o_s != 0).sum()) / Lv:.2f}")
    plain_v = tcd.CDOptions(use_pallas=False)
    reset_counts()
    (o_p, _), t_p = wall(lambda: vc_l1(vp.lam0, zgrid=zgv[:100],
                                       options=plain_v, grid_batch=0))
    if any(counts().values()):
        fail("use_pallas=False launched a kernel")
    bad = support_mismatch(o_s[:, :100], o_p, supp_tol)
    log(f"locpolyl1 scan, first 100 points: plain {t_p:.4f} s; kernels vs "
        f"plain support differing above {supp_tol:g}: {bad}, in all "
        f"{int(((o_s[:, :100] != 0) != (o_p != 0)).sum())}, max |diff| "
        f"{maxdiff(o_s[:, :100], o_p):.3e}")
    if bad:
        fail("locpolyl1: kernel and plain scans differ in support")

    def vc_batched(lam):
        st = {}
        with warnings.catch_warnings(record=True) as wl:
            warnings.simplefilter("always")
            out = vc_l1(lam, grid_batch=128, stats=st)
        fell = [str(w.message) for w in wl
                if issubclass(w.category, RuntimeWarning)]
        if fell or not (st["used_batched"] and st["batched_certified"]):
            fail(f"the batched grid fell back to the scan: {st} {fell}")
        return out, st

    ((o_b, r_b), st_vb), t_bf = wall(lambda: vc_batched(vp.lam0))
    t_b = math.inf
    for rep in range(2):
        reset_counts()
        (_, st_last), t = wall(
            lambda: vc_batched(vp.lam0 * (1.0 + 1e-7 * (rep + 1))))
        t_b = min(t_b, t)
    launches_b, reads_b = counts(), dict(host.COUNTS)
    add(launches_b)
    if not 0 < launches_b["vc_round"] == st_last["refine_rounds"]:
        fail(f"the batched grid launched vc_round {launches_b['vc_round']} "
             f"times in {st_last['refine_rounds']} refine rounds")
    vc_finite("locpolyl1 batched", o_b, (ep_v, Lv))
    vc_finite("locpolyl1 batched refits", r_b, (ep_v, Lv))
    bad = support_mismatch(o_b, o_s, supp_tol)
    log(f"locpolyl1 batched (grid_batch=128): first {t_bf:.4f} s, warm "
        f"{t_b:.4f} s (min of 2); stats {st_vb}; launches {launches_b}; host "
        f"reads {reads_b['host_reads']} over {reads_b['epochs']} epochs; vs "
        f"scan: max |dbeta| {maxdiff(o_b, o_s):.3e}, support differing above "
        f"{supp_tol:g}: {bad}, in all {int(((o_b != 0) != (o_s != 0)).sum())}"
        f"; max |drefit| {maxdiff(r_b, r_s):.3e}")
    if bad:
        fail("locpolyl1: the batched grid and the scan differ in support")

    # the batched grid's refine round at its shape (128 lanes of the grid,
    # 16 steps, from random sparse starts): the vc-round kernel against its
    # plain twin, float32 (X in shared memory) and float64 (X from L2),
    # within 1e-4 / 1e-10 of max |B|; the certificates' decisions equal
    for dt_v in (torch.float32, torch.float64):
        kv = 128
        Xr, zr, yr = (a.to(dt_v) for a in (Xv, zv, yv))
        z0r = torch.linspace(0.05, 0.95, kv, dtype=dt_v, device=dev)
        with block_cd.full_f32_matmuls():
            ops_v = vcm._VcBatchOps(Xr, zr, yr, kern_v, z0r, vp.degree,
                                    tcd.CDOptions())
        gv_ = torch.Generator(device=dev).manual_seed(22)
        Bv = 0.1 * torch.randn((kv, ops_v.ep), generator=gv_, device=dev,
                               dtype=dt_v) * (torch.rand(
                                   (kv, ops_v.ep), generator=gv_,
                                   device=dev) < 0.2)
        state_v = (Bv, torch.zeros((kv,), dtype=torch.bool, device=dev),
                   torch.full((kv,), math.inf, dtype=dt_v, device=dev),
                   torch.zeros((kv,), dtype=torch.int32, device=dev),
                   torch.zeros((kv,), dtype=torch.bool, device=dev),
                   (ops_v.lamw * vcm._thr_scale(vp.lam0, nv, dt_v))
                   .contiguous())

        def vc_kernel():
            return vc_round.fused_vc_round(ops_v, *state_v)

        def vc_plain():
            with block_cd.full_f32_matmuls():
                return ops_v.round_plain(*state_v)

        out_v, ref_v = vc_kernel(), vc_plain()
        if not all(torch.equal(out_v[i], ref_v[i]) for i in (3, 5, 6)):
            fail("vc_round: cert, stall or esc differ from the plain twin")
        ms = cuda_ms(vc_kernel, 50)
        pms = cuda_ms(vc_plain, 5)
        _, names, dms = one_call(vc_kernel)
        dms = dms if names else None
        item_v = Bv.element_size()
        q1v, pv = vp.degree + 1, Xv.shape[1]
        route_v = vc_round.pick_route(nv, pv, q1v, item_v,
                                      _build.smem_optin(dev))
        f64v = dt_v == torch.float64
        report(None if f64v else "vc_round",
               "vc round" + (" (float64)" if f64v else ""),
               maxdiff(out_v[0], ref_v[0]),
               (1e-10 if f64v else 1e-4) * float(ref_v[0].abs().max()), ms,
               pms, f"k={kv}, n={nv}, p={pv}, q1={q1v}, "
               f"{len(ops_v.coefs)} steps, route {route_v}; device "
               + ("not measured" if dms is None else f"{dms:.4f} ms"),
               item_v * (nv * pv + nv + kv * (3 * nv * q1v + 2 * nv
                                              + 6 * pv * q1v)),
               4 * kv * (len(ops_v.coefs) + 1) * nv * pv * q1v,
               peak="f64" if f64v else "f32", device_ms=dms)
        if not ok:
            fail("vc_round disagrees with its plain twin")
        del ops_v, state_v, out_v, ref_v, Bv

    lp, t_lpf = wall(lambda: tcd.locpoly(Xv, zv, yv, zgv, vp.degree, kern_v))
    t_lp = math.inf
    for rep in range(2):
        _, t = wall(lambda: tcd.locpoly(
            Xv, zv, yv, zgv, vp.degree,
            tcd.GaussianKernel(vp.h + 1e-7 * (rep + 1))))
        t_lp = min(t_lp, t)
    vc_finite("locpoly", lp, (ep_v, Lv))
    Xn, zn, yn = (a.double().cpu().numpy() for a in (Xv, zv, yv))
    hn = float(np.float32(vp.h))
    worst = 0.0
    for i in (0, Lv // 2, Lv - 1):
        z0 = float(np.float32(zgv[i]))
        wn = np.exp(-((zn - z0) ** 2) / hn) / hn
        eXn = (Xn[:, :, None] * ((zn - z0)[:, None, None]
                                 ** np.arange(vp.degree + 1))).reshape(nv, -1)
        ref = np.linalg.solve(eXn.T @ (wn[:, None] * eXn), eXn.T @ (wn * yn))
        worst = max(worst, float(np.abs(lp[:, i].double().cpu().numpy() - ref)
                                 .max() / np.abs(ref).max()))
    log(f"locpoly ({Lv} points): first {t_lpf:.4f} s, warm {t_lp:.4f} s "
        f"(min of 2); three points vs a float64 normal-equation solve: max "
        f"relative error {worst:.3e} (tol 1.0e-04)")
    if not worst <= 1e-4:
        fail("locpoly disagrees with the float64 normal equations")

    def vc_lvocv(hs, **kw):
        st = {}
        with warnings.catch_warnings(record=True) as wl:
            warnings.simplefilter("always")
            mse = tcd.lvocv_locpolyl1(Xv, zv, yv, vp.degree, hs,
                                      tcd.GaussianKernel, vp.lam0, stats=st,
                                      **kw)
        fell = [str(w.message) for w in wl
                if issubclass(w.category, RuntimeWarning)]
        return mse, st, fell

    reset_counts()
    (mse_b, st_cv, fell), t_cvf = wall(lambda: vc_lvocv(list(vp.h_arr),
                                                        cv_batch=128))
    launches_cv = counts()
    add(launches_cv)
    t_cv = math.inf
    for rep in range(2):
        (_, st_r, fell_r), t = wall(lambda: vc_lvocv(
            [h * (1.0 + 1e-7 * (rep + 1)) for h in vp.h_arr], cv_batch=128))
        t_cv = min(t_cv, t)
        fell += fell_r
    reset_counts()
    (mse_s, _, _), t_seq = wall(lambda: vc_lvocv([0.2], cv_batch=0))
    launches_seq, reads_seq = counts(), dict(host.COUNTS)
    add(launches_seq)
    vc_finite("lvocv_locpolyl1 batched", mse_b, (len(vp.h_arr),))
    vc_finite("lvocv_locpolyl1 sequential", mse_s, (1,))
    rel_cv = abs(float(mse_b[2]) - float(mse_s[0])) / float(mse_s[0])
    log(f"lvocv_locpolyl1 (n={nv}, h {list(vp.h_arr)}): batched first "
        f"{t_cvf:.4f} s, warm {t_cv:.4f} s (min of 2), stats {st_cv}, "
        f"fallbacks {len(fell)}, launches {launches_cv}; sequential at h = "
        f"0.2: {t_seq:.4f} s, launches {launches_seq}, host reads "
        f"{reads_seq['host_reads']} over {reads_seq['epochs']} epochs; MSE "
        f"{[round(float(m), 6) for m in mse_b]}; at h = 0.2 batched "
        f"{float(mse_b[2]):.6f} vs sequential {float(mse_s[0]):.6f}: "
        f"relative difference {rel_cv:.3e} (tol 5.0e-02)")
    if not rel_cv <= 5e-2:
        fail("lvocv_locpolyl1: batched and sequential scores disagree")
    vc_launches = {"K1wls_vc": launches_j["K1wls"], "K3_vc": launches_j["K3"],
                   "K4_vc": launches_j["K4"], "K5_vc": launches_j["K5"]}

    # 5. the port's bench in small mode, the four demos and the scaling
    # measurement's card mode (a world of one, NCCL), each a process of its
    # own on this card, run together; any failure fails the run
    t_5 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, BENCH_SMALL="1", PYTHONPATH=os.pathsep.join(
        [root] + [v for v in [os.environ.get("PYTHONPATH")] if v]))
    mods = ["coordinatedescent_jl_tpu_torch.bench"] + [
        f"coordinatedescent_jl_tpu_torch.examples.{e}" for e in (
            "atoms_demo", "lasso_path_demo", "multichip_demo",
            "production_recipes")] + [
        "coordinatedescent_jl_tpu_torch.multiproc_bench"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", m] + ([] if m.endswith(".bench")
                                     else ["--small"]),
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for m in mods]
    outs = []
    try:
        for m, pr in zip(mods, procs):
            out, err = pr.communicate(timeout=600)
            outs.append(out)
            log(f"5 {m}: exit code {pr.returncode}, "
                f"{time.perf_counter() - t_5:.1f} s after the start")
            if pr.returncode:
                print(err[-4000:], file=sys.stderr)
                fail(f"5: {m} exited with {pr.returncode}")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    lines = [ln for ln in outs[0].splitlines() if ln.startswith("{")]
    full_b, compact_b = (json.loads(ln) for ln in lines[-2:])
    details = compact_b["details"]
    # small mode skips the roofline, p = 1M and the multi-process sections
    want = [k for k in pbench.COMPACT_KEYS
            if not ("p1m" in k or k.startswith(("pass_roofline",
                                                 "multiproc")))]
    missing = [k for k in want if k not in details]
    uncertified = [k for k, v in details.items()
                   if k.endswith("_certified") and v is not True]
    errors = [k for k in full_b["full_details"] if k.endswith("_error")]
    log(f"5 bench (BENCH_SMALL=1): {compact_b['metric']} value "
        f"{compact_b['value']} s, vs_baseline {compact_b['vs_baseline']}; "
        f"{len(details)} compact keys, missing {missing}, not certified "
        f"{uncertified}, errors {errors}")
    log(f"5 bench details: {json.dumps(details)}")
    if (compact_b["metric"] != "lasso_path_wall_time_small"
            or full_b["metric"] != compact_b["metric"] or missing
            or uncertified or errors):
        fail("5: the bench's small run lacks a key, a certificate or ran "
             "into an error")
    for m, out in zip(mods[1:-1], outs[1:-1]):
        log(f"5 {m.rsplit('.', 1)[1]} --small: " + " | ".join(
            out.strip().splitlines()[:3]))
    mp = json.loads([ln for ln in outs[-1].splitlines()
                     if ln.startswith("{")][-1])
    log(f"5 multiproc_bench --small on the card: {json.dumps(mp)}")
    if (mp["device"] != "cuda" or "1" not in mp["curve"]
            or not mp["curve"]["1"]["nnz"] or not mp["nnz_agree"]
            or any(r["max_abs_diff_vs_1"] > 1e-4
                   for r in mp["curve"].values())):
        fail("5: multiproc_bench's card mode gave no solution on the card")
    log(f"phase 5: {time.perf_counter() - t_5:.1f} s")

    src = "coordinatedescent_jl_tpu_torch/csrc/"
    meta = {
        "K1": ("fused_active_pass", "active_pass.cu",
               "coordinatedescent_jl_tpu/ops/pallas_block.py:537"),
        "K1f64": ("fused_active_pass (float64, exact)", "active_pass.cu",
                  "coordinatedescent_jl_tpu/ops/pallas_block.py:537"),
        "K1wls": ("fused_active_pass (wls)", "active_pass.cu",
                  "coordinatedescent_jl_tpu/ops/pallas_block.py:537"),
        "K1sqrt": ("fused_active_pass (sqrt)", "active_pass.cu",
                   "coordinatedescent_jl_tpu/ops/pallas_block.py:537"),
        "K1sqrt_f64": ("fused_active_pass (sqrt, float64, exact)",
                       "active_pass.cu",
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
        "LD": ("loadings_sweep (get_loadings_blocked; launches: both "
               "forms)", "dense_sweep.cu",
               "none: the JAX package's loadings are plain jnp "
               "(coordinatedescent_jl_tpu/utils/helpers.py get_loadings)"),
        "LDf64": ("loadings_f64_sweep (loadings_f64; launches: 4f's polish)",
                  "dense_sweep.cu",
                  "none: coordinatedescent_jl_tpu/ops/compensated.py "
                  "loadings_f64 is an einsum"),
        "union_fista": ("fused_union_fista (the batched path's refine "
                        "round)", "union_fista.cu",
                        "none: coordinatedescent_jl_tpu/ops/"
                        "batched_certify.py:union_block_fista is a lax.scan"),
        "GP": ("fused_group_pass (the group engine's active pass)",
               "group_pass.cu",
               "none: coordinatedescent_jl_tpu/ops/group_cd.py's visit runs "
               "outside Pallas"),
        "vc_round": ("fused_vc_round (the varying-coefficient grid's refine "
                     "round)", "vc_round.cu",
                     "none: coordinatedescent_jl_tpu/models/"
                     "varying_coefficient.py's batched rounds run outside "
                     "Pallas"),
        "K1wls_vc": ("fused_active_pass (wls, n = 500: the small-n regime, "
                     "one cluster)",
                     "active_pass.cu",
                     "coordinatedescent_jl_tpu/ops/pallas_block.py:339"),
        "K3_vc": ("check_phase_a (screen off, one block)", "check.cu",
                  "coordinatedescent_jl_tpu/ops/pallas_check.py:108"),
        "K4_vc": ("check_phase_b (one block)", "check.cu",
                  "coordinatedescent_jl_tpu/ops/pallas_check.py:149"),
        "K5_vc": ("fused_gradient_sweep (one block, n = 500, one cluster)",
                  "dense_sweep.cu",
                  "coordinatedescent_jl_tpu/ops/pallas_block.py:657"),
        "K3_ws": ("check_phase_a (one CTA: the working set of at most 8 "
                  "blocks, screen on)", "check.cu",
                  "coordinatedescent_jl_tpu/ops/pallas_check.py:108"),
        "K4_ws": ("check_phase_b (one CTA: the working set of at most 8 "
                  "blocks)", "check.cu",
                  "coordinatedescent_jl_tpu/ops/pallas_check.py:149"),
        "K5_p1m": ("fused_gradient_sweep (7,813 blocks of (1,000, 128): "
                   "p = 1M)", "dense_sweep.cu",
                   "coordinatedescent_jl_tpu/ops/pallas_block.py:657"),
        "K1_n1000": ("fused_active_pass (n = 1,000: the cluster route, the "
                     "p = 1M solve's working set)", "active_pass.cu",
                     "coordinatedescent_jl_tpu/ops/pallas_block.py:339"),
        "K3_p1m": ("check_phase_a (7,813 rows: p = 1M, screen on)",
                   "check.cu",
                   "coordinatedescent_jl_tpu/ops/pallas_check.py:108"),
        "K4_p1m": ("check_phase_b (7,813 rows: p = 1M)", "check.cu",
                   "coordinatedescent_jl_tpu/ops/pallas_check.py:149"),
        "BL": ("blockify (the design's padded blocked copy and column sums "
               "of squares; launches: every ls / sqrt / unweighted group "
               "build)", "blockify.cu",
               "none: the JAX package's set-up is jnp.pad + reshape/"
               "transpose + jnp.sum under XLA"),
        "BL_p1m": ("blockify (1,000 x 1,000,000; launches: 4m's builds)",
                   "blockify.cu",
                   "none: the JAX package's set-up is jnp.pad + reshape/"
                   "transpose + jnp.sum under XLA"),
    }
    log(f"launches over the main-path runs: {total}; the 4j scan's: "
        f"{vc_launches}; the one-CTA route's in the 4a scan: {ws_launches}; "
        f"4m's at the p = 1M shapes: {p1m_launches}")
    launched = {**total, **vc_launches, **ws_launches, **p1m_launches,
                "LDf64": ld_f64_launches, "BL_p1m": m_launches["BL"]}
    kernels = [{"name": meta[k][0], "route": "cuda", "source": src + meta[k][1],
                "replaces": meta[k][2], "launches": launched[k], **rec[k]}
               for k in meta]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
