"""Where the time goes on the port's main paths, on one GPU.

    python -m coordinatedescent_jl_tpu_torch.profile_paths

On the bench problem (:func:`bench_problem`, which ``chip_smoke.py``
drives too), each path is run once to warm up, once unprofiled for its
wall time and counters, then once under ``torch.profiler`` (CPU + CUDA):

- ``scan``: the 100-point ``lasso_path`` (``path_batch=0``);
- ``batched``: the same grid with ``path_batch=128, coarse_stride=99``;
- ``polish``: ``lasso`` at 0.05·λmax (default options) + ``polish_lasso``;
- ``sqrt``, ``scaled``, ``feasible``: ``sqrt_lasso`` at 1.1·sqrt(2 ln p)
  (bench.py's options), ``scaled_lasso`` and ``feasible_lasso`` at
  sqrt(2 ln p / n)·(1 + 1e-7) (default options: the calls bench.py and
  ``chip_smoke.py`` time);
- ``sqrt_polish``, ``scaled_polish``, ``feasible_polish``: the float64
  polish of each of those solutions;
- ``scaled_lam``, ``feasible_lam``: the same two estimators at sqrt(2 ln p
  / n) itself (bench.py's first, untimed call).  At the default float32
  ``opt_tol = 1e-7`` the epochs of a solve depend on whether an inner
  working-set solve reaches the tolerance or runs to ``max_iter``, and
  these two levels, 1e-7 apart, differ in that;
- ``wls``: one ``coordinate_descent(WeightedLSLoss, ProxL1)`` solve with
  random row weights in [0.5, 1.5] at 0.05·λmax of the weighted problem;
- ``group``, ``group_polish``: after the bench design is freed, the group
  bench problem (:func:`group_bench_problem`, bench.py's group section):
  ``group_lasso`` at 0.3·group-λmax·(1 + 1e-7) with ``opt_tol=1e-6,
  randomize=False``, then ``polish_group_lasso`` of its solution.

    python -m coordinatedescent_jl_tpu_torch.profile_paths --vc

profiles instead the varying-coefficient suite on its bench configuration
(:func:`vc_bench_problem`, which ``chip_smoke.py`` 4j drives too):

- ``vc_scan``: ``locpolyl1`` over the 1000-point grid, ``grid_batch=0``;
- ``vc_scan_exact``: the same with ``CDOptions(inner="exact")``;
- ``vc_batched``: the same grid with ``grid_batch=128``;
- ``vc_locpoly``: ``locpoly`` on the same grid;
- ``vc_lvocv``: ``lvocv_locpolyl1`` over the four bandwidths,
  ``cv_batch=128``;
- ``vc_lvocv_seq``: the sequential LOO-CV (``cv_batch=0``) at h = 0.2.

The scans and the sequential LOO-CV launch about a million kernels, and
reading a trace that long takes the profiler many minutes: their traces
cover the first 100 grid points, or the first 50 held-out rows, and the
record says so (``traced``); wall, reads, epochs and launches are the
whole run's.

For each it prints one JSON line: the wall time, the device time (the
sum of the kernels' durations in the trace), the device's idle share,
the number of device kernels, the top kernels by time, the device time
and calls of each of the port's own kernels (``cdt``), the host reads
and the kernel launch counters.  The batched line adds the refine rounds
(``stats``) and the kernels and device time inside the
``union_block_fista`` spans; a polish line adds its rounds, whether it
converged and (where the result has one) its support.  The line before
them gives the card's name and power limit.  Needs a CUDA GPU.

    python -m coordinatedescent_jl_tpu_torch.profile_paths --obs

profiles instead the runs of ``chip_smoke.py`` 4k (profiling and
checkpointing, ``utils/``): on the bench problem, ``resumable``
(``lasso_path_resumable`` over the 100 points, ``checkpoint_every=1``,
its file under ``build/``), ``x_traffic`` (``solve_x_traffic`` at
0.05·λmax·(1 + 2e-7), default options: three solves), ``epoch_trace``
(``solve_with_trace`` at that level), ``sigma_trace``
(``scaled_lasso_with_trace`` at sqrt(2 ln p / n)·(1 + 1e-7)); then, on
the group problem, ``group_trace`` (``group_solve_with_trace``).

    python -m coordinatedescent_jl_tpu_torch.profile_paths --par

profiles instead the runs of ``chip_smoke.py`` 4l(a) (the multi-device
tiers, ``parallel/``) on a world of one rank (NCCL over a ``HashStore``):
on the bench problem ``par_lasso`` (``lasso_sharded`` at 0.05·λmax·(1 +
2e-7)), ``par_scan`` and ``par_batched`` (``lasso_path_sharded``, the scan
and ``path_batch=128, coarse_stride=99``), ``par_sqrt``, ``par_scaled``,
``par_feasible`` (the levels and options of ``sqrt``, ``scaled`` and
``feasible`` above), ``par_trace`` (``lasso_sharded_with_trace`` at
0.05·λmax·(1 + 2e-7)); then ``par_group`` (``group_lasso_sharded`` on the
group problem).  Each of these records also holds ``collectives``: the
run's collectives by kind, calls and bytes (``parallel/_collectives.py``).

    python -m coordinatedescent_jl_tpu_torch.profile_paths --trace-probe 1500

counts instead how many of that many one-call traces (:func:`trace_one_call`
on K1's wls form at the working set's shape, random data) the tracer
returned short of the launch the wrapper counted, and had to be retaken.
"""

from __future__ import annotations

import collections
import json
import math
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .utils import host
from .utils.options import CDOptions

# lasso_path._refine_chunk's profiler span (utils/host.py)
_SPAN = host.SPAN_PREFIX + "path.union_block_fista"


class BenchProblem(NamedTuple):
    X: torch.Tensor          # (n, p) float32, dense Gaussian
    y: torch.Tensor          # X β + N(0, 1)
    support: torch.Tensor    # the s planted coordinates
    beta_true: torch.Tensor  # (p,) planted β
    lammax: float
    lams: np.ndarray         # 0.5·λmax → 0.05·λmax, log-spaced
    opts: CDOptions


def bench_problem(dev, n: int = 10_000, p: int = 100_000, s: int = 100,
                  L: int = 100, seed: int = 0) -> BenchProblem:
    """The bench problem (bench.py's construction, made on ``dev`` from
    ``seed``): dense Gaussian X, a scattered planted support of ``s``,
    unit noise, an ``L``-point grid and the bench's solver options."""
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((n, p), generator=g, device=dev)
    support = torch.randperm(p, generator=g, device=dev)[:s]
    beta_true = torch.zeros((p,), device=dev)
    beta_true[support] = torch.randn((s,), generator=g, device=dev)
    y = X @ beta_true + torch.randn((n,), generator=g, device=dev)
    lammax = float(torch.max(torch.abs(y @ X)) / n)
    lams = np.exp(np.linspace(np.log(0.5 * lammax), np.log(0.05 * lammax), L))
    opts = CDOptions(opt_tol=1e-6, max_iter=300, block_size=128,
                     randomize=False, block_iters=16)
    return BenchProblem(X, y, support, beta_true, lammax, lams, opts)


class GroupBenchProblem(NamedTuple):
    X: torch.Tensor          # (n, p) float32, dense Gaussian
    y: torch.Tensor          # X β + 0.3·N(0, 1)
    groups: torch.Tensor     # the planted groups (β = 1 on each)
    G: int
    lam: float               # 0.3·group-λmax
    opts: CDOptions


def group_bench_problem(dev, n: int = 10_000, p: int = 100_000, G: int = 8,
                        n_act: int = 12, seed: int = 11) -> GroupBenchProblem:
    """The group Lasso bench problem (bench.py's group section, made on
    ``dev`` from ``seed``): dense Gaussian X, ``n_act`` planted groups of
    ``G`` coordinates set to 1.0, noise 0.3, λ = 0.3·max_g ‖X_g'y‖/n, and
    the bench's options (``opt_tol=1e-6, randomize=False``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((n, p), generator=g, device=dev)
    groups = torch.randperm(p // G, generator=g, device=dev)[:n_act]
    beta = torch.zeros((p // G, G), device=dev)
    beta[groups] = 1.0
    y = X @ beta.reshape(-1) + 0.3 * torch.randn((n,), generator=g,
                                                 device=dev)
    gn = torch.linalg.vector_norm((y @ X).reshape(-1, G), dim=1) / n
    return GroupBenchProblem(X, y, groups, G, 0.3 * float(torch.max(gn)),
                             CDOptions(opt_tol=1e-6, randomize=False))


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, by the names ``chip_smoke.py``
    reports them under."""
    from .kernels import (active_pass, check, group_pass, union_fista,
                          vc_round)
    from .kernels import gradient_sweep as gs

    k1 = active_pass.LAUNCHES_KIND
    return {"K1": k1["ls"][0], "K1f64": k1["ls"][1], "K1wls": k1["wls"][0],
            "K1sqrt": k1["sqrt"][0], "K1sqrt_f64": k1["sqrt"][1],
            "K2": gs.LAUNCHES, "K3": check.LAUNCHES_A, "K4": check.LAUNCHES_B,
            "K5": gs.LAUNCHES_DENSE, "K5f64": gs.LAUNCHES_F64,
            "union_fista": union_fista.LAUNCHES, "GP": group_pass.LAUNCHES,
            "vc_round": vc_round.LAUNCHES}


def reset_launch_counts():
    from .kernels import (active_pass, check, group_pass, union_fista,
                          vc_round)
    from .kernels import gradient_sweep as gs

    for by_dtype in active_pass.LAUNCHES_KIND.values():
        by_dtype[0] = by_dtype[1] = 0
    gs.LAUNCHES = gs.LAUNCHES_DENSE = gs.LAUNCHES_F64 = 0
    check.LAUNCHES_A = check.LAUNCHES_B = 0
    union_fista.LAUNCHES = group_pass.LAUNCHES = vc_round.LAUNCHES = 0
    for by_shape in (active_pass.LAUNCHES_SHAPE, check.LAUNCHES_SHAPE,
                     gs.LAUNCHES_DENSE_SHAPE):
        by_shape.clear()


class VcBenchProblem(NamedTuple):
    X: torch.Tensor          # (n, p) float32, dense Gaussian
    z: torch.Tensor          # (n,) U(0, 1)
    y: torch.Tensor          # sin(2πz)·X[:, 0] + 0.3·N(0, 1)
    zgrid: np.ndarray        # the evaluation grid
    degree: int
    h: float                 # the Gaussian kernel's bandwidth
    lam0: float
    h_arr: tuple             # the LOO-CV's bandwidths


def vc_bench_problem(dev, n: int = 500, p: int = 50, g: int = 1000,
                     seed: int = 7) -> VcBenchProblem:
    """The varying-coefficient bench configuration (bench.py:480-611, the
    shapes of the reference's ``benchmark/locpoly_bench.jl``), made from a
    numpy ``seed`` and moved to ``dev`` in float32: dense Gaussian X,
    z ~ U(0, 1), y = sin(2πz)·X[:, 0] + 0.3·N(0, 1), degree 1,
    ``GaussianKernel(0.1)``, λ0 = 0.05 and a ``g``-point grid
    ``linspace(0.05, 0.95, g)``; the LOO-CV's bandwidths."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.0, 1.0, n)
    X = rng.standard_normal((n, p))
    y = np.sin(2 * np.pi * z) * X[:, 0] + 0.3 * rng.standard_normal(n)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    return VcBenchProblem(f32(X), f32(z), f32(y),
                          np.linspace(0.05, 0.95, g), 1, 0.1, 0.05,
                          (0.08, 0.12, 0.2, 0.3))


def trace_one_call(fn, retakes: int = 10):
    """One call of ``fn`` (warmed up first) under ``torch.profiler``:
    ``(host reads, device kernels' names, their ms, launches the wrappers
    counted, traces retaken)``.

    The tracer (Kineto) now and then discards a kernel's record as outside
    its capture window (its log counts the record "Out-of-range"; padding
    the window with sleeps or tracing the CPU as well changes nothing).  The
    wrappers' launch counters tell that loss from a wrapper that launched
    nothing: a trace with fewer device kernels than launches counted lost a
    record and is taken again, at most ``retakes`` times (the losses come
    a few in a row); a trace with as
    many or more is returned as it is, so a call that launched no kernel,
    or more kernels than its wrappers counted, still shows as such."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for retaken in range(retakes + 1):
        torch.cuda.synchronize()
        reads = host.COUNTS["host_reads"]
        before = sum(launch_counts().values())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counted = sum(launch_counts().values()) - before
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not host.is_program_range(e.name)]
        if len(kern) >= counted:
            break
    return (host.COUNTS["host_reads"] - reads, [e.name for e in kern],
            sum(e.time_range.elapsed_us() for e in kern) * 1e-3, counted,
            retaken)


def trace_probe(traces: int):
    """Print how many of ``traces`` one-call traces of K1 (wls, FISTA, 8
    blocks of n = 10,000 rows, random data) had to be retaken."""
    from .kernels import active_pass
    from .ops import block_cd

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    n, B = 10_000, 128
    X = torch.randn((n, 8 * B), generator=g, device=dev)
    y = torch.randn((n,), generator=g, device=dev)
    w = 0.5 + torch.rand(n, generator=g, device=dev)
    prob = block_cd.build_blocked(
        "wls", CDOptions(block_size=B, cache_gram=True, compact=False),
        torch.ones(8 * B, device=dev), X=X, y=y, w=w)
    st = block_cd._init_state("wls", prob, torch.zeros((8, B), device=dev),
                              None)
    args = (prob, st.beta, st.r, torch.ones(8, dtype=torch.bool, device=dev),
            0.05, float(n), torch.arange(8, device=dev),
            torch.arange(B, device=dev))
    hist = collections.Counter()
    for _ in range(traces):
        _, names, _, counted, retaken = trace_one_call(
            lambda: active_pass.fused_active_pass(
                *args, kind="wls", inner="ista", iters=16, rsqr=st.rsqr))
        if len(names) != 1 or counted != 1:
            print(f"trace_probe: {len(names)} kernel(s), {counted} counted",
                  file=sys.stderr)
            sys.exit(1)
        hist[retaken] += 1
    print(json.dumps({"traces": traces, "retaken": dict(sorted(hist.items()))}),
          flush=True)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _span_kernels(ev):
    """The device kernels launched under a CPU event and its children."""
    ks = list(ev.kernels)
    for ch in ev.cpu_children:
        ks += _span_kernels(ch)
    return ks


def _trace(fn, top: int = 8):
    """Run ``fn`` under the profiler: wall seconds, device seconds, kernel
    count, the top kernels by device time, and the ``_SPAN`` spans."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(fn)
    evs = prof.events()
    # the spans' and marks' device-side annotations are ranges, not kernels
    dev_evs = [e for e in evs
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not host.is_program_range(e.name)]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in dev_evs:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() * 1e-6
    busy = sum(v[1] for v in by_name.values())
    tops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    # the port's own kernels (namespace cdt), whether in the top or not
    ours = collections.defaultdict(lambda: [0, 0.0])
    for name, (calls, secs) in by_name.items():
        if "cdt::" in name:
            key = name.split("(")[0].split("cdt::")[-1]
            ours[key][0] += calls
            ours[key][1] += secs
    spans = [e for e in evs if e.name == _SPAN
             and e.device_type == torch.autograd.DeviceType.CPU]
    span_k = [k for e in spans for k in _span_kernels(e)]
    return {"profiled_wall_s": wall, "device_s": busy,
            "idle_share": 1.0 - busy / wall if wall > 0 else None,
            "kernels": len(dev_evs),
            "top": [{"name": k[:80], "calls": c, "s": t}
                    for k, (c, t) in tops],
            "cdt": {k: {"calls": c, "s": t}
                    for k, (c, t) in sorted(ours.items())},
            "fista_spans": {"count": len(spans), "kernels": len(span_k),
                            "device_s": sum(k.duration for k in span_k) * 1e-6,
                            "host_s": sum(e.cpu_time_total
                                          for e in spans) * 1e-6}}


def _run(name, fn, extra=dict, traced=None):
    """Warm up ``fn``, run it once for its wall time, host reads and launch
    counts, then once under the profiler (or ``traced``, a shorter part of
    it); print the record (``extra()`` adds fields read after the timed
    run)."""
    from .parallel import _collectives
    from .utils import host

    fn()                                          # warm-up
    reset_launch_counts()
    host.reset()
    _collectives.reset()
    _, wall = _timed(fn)
    rec = {"path": name, "wall_s": wall, **dict(host.COUNTS),
           "launches": launch_counts(), **extra()}
    if any(c for c, _ in _collectives.COUNTS.values()):
        rec["collectives"] = {k: {"calls": c, "bytes": b} for k, (c, b)
                              in _collectives.COUNTS.items()}
    rec.update(_trace(traced or fn))
    print(json.dumps(rec), flush=True)


def vc_main():
    """The ``--vc`` runs (see the module docstring)."""
    import coordinatedescent_jl_tpu_torch as tcd

    vp = vc_bench_problem(torch.device("cuda", 0))
    kern = tcd.GaussianKernel(vp.h)
    stats = {}

    def scan(grid=vp.zgrid, **kw):
        tcd.locpolyl1(vp.X, vp.z, vp.y, grid, vp.degree, kern, vp.lam0,
                      grid_batch=0, **kw)

    exact = CDOptions(inner="exact")

    def batched():
        tcd.locpolyl1(vp.X, vp.z, vp.y, vp.zgrid, vp.degree, kern, vp.lam0,
                      grid_batch=128, stats=stats)

    def locpoly():
        tcd.locpoly(vp.X, vp.z, vp.y, vp.zgrid, vp.degree, kern)

    def lvocv():
        tcd.lvocv_locpolyl1(vp.X, vp.z, vp.y, vp.degree, vp.h_arr,
                            tcd.GaussianKernel, vp.lam0, cv_batch=128,
                            stats=stats)

    def lvocv_seq():
        tcd.lvocv_locpolyl1(vp.X, vp.z, vp.y, vp.degree, [0.2],
                            tcd.GaussianKernel, vp.lam0, cv_batch=0)

    def lvocv_seq_50():
        from .models.varying_coefficient import _lvocv_locpolyl1_one_h

        _lvocv_locpolyl1_one_h(vp.X, vp.z, vp.y, vp.z.tolist(), 0.2,
                               vp.lam0, 0, vp.degree, tcd.GaussianKernel,
                               CDOptions(), points=list(range(50)))

    grid100 = vp.zgrid[:100]
    for name, fn, traced, what in (
            ("vc_scan", scan, lambda: scan(grid100), "the first 100 points"),
            ("vc_scan_exact", lambda: scan(options=exact),
             lambda: scan(grid100, options=exact), "the first 100 points"),
            ("vc_batched", batched, None, "all"),
            ("vc_locpoly", locpoly, None, "all"),
            ("vc_lvocv", lvocv, None, "all"),
            ("vc_lvocv_seq", lvocv_seq, lvocv_seq_50,
             "the first 50 held-out rows")):
        stats.clear()
        _run(name, fn, lambda: {"stats": dict(stats), "traced": what},
             traced)


def obs_main():
    """The ``--obs`` runs (see the module docstring)."""
    import os

    import coordinatedescent_jl_tpu_torch as tcd

    bp = bench_problem(torch.device("cuda", 0))
    X, y, lams, opts = bp.X, bp.y, bp.lams, bp.opts
    n, p = X.shape
    lam_t = float(lams[-1]) * (1.0 + 2e-7)
    lam_sc = math.sqrt(2 * math.log(p) / n) * (1.0 + 1e-7)
    ck = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build", "profile_checkpoint.npz")

    def resumable():
        if os.path.exists(ck):
            os.remove(ck)
        tcd.lasso_path_resumable(X, y, lams, ck, options=opts,
                                 standardize_X=False, checkpoint_every=1)

    for name, fn in (
            ("resumable", resumable),
            ("x_traffic", lambda: tcd.solve_x_traffic(X, y, lam_t)),
            ("epoch_trace", lambda: tcd.solve_with_trace(X, y, lam_t)),
            ("sigma_trace", lambda: tcd.scaled_lasso_with_trace(X, y,
                                                                lam_sc))):
        _run(name, fn)
    os.remove(ck)
    del X, y, bp
    torch.cuda.empty_cache()
    gp = group_bench_problem(torch.device("cuda", 0))
    _run("group_trace", lambda: tcd.group_solve_with_trace(
        gp.X, gp.y, gp.lam * (1.0 + 1e-7), gp.G, options=gp.opts))


def par_main():
    """The ``--par`` runs (see the module docstring)."""
    import torch.distributed as dist

    import coordinatedescent_jl_tpu_torch as tcd
    from . import parallel as par
    from .parallel import distributed as pdist

    pdist.initialize_distributed(backend="nccl", store=dist.HashStore(),
                                 num_processes=1, process_id=0, timeout=600)
    mesh = pdist.feature_mesh()
    bp = bench_problem(torch.device("cuda", 0))
    X, y, lams, opts = bp.X, bp.y, bp.lams, bp.opts
    n, p = X.shape
    lam_t = float(lams[-1]) * (1.0 + 2e-7)
    lam_sc = math.sqrt(2 * math.log(p) / n) * (1.0 + 1e-7)
    lam_sq = 1.1 * math.sqrt(2 * math.log(p))
    opts_sq = CDOptions(opt_tol=1e-6, max_iter=300, randomize=False,
                        block_size=128)
    stats = {}

    def batched():
        stats.clear()
        par.lasso_path_sharded(X, y, lams, mesh, options=opts,
                               standardize_X=False, path_batch=128,
                               coarse_stride=len(lams) - 1, stats=stats)

    for name, fn in (
            ("par_lasso", lambda: par.lasso_sharded(X, y, lam_t, mesh)),
            ("par_scan", lambda: par.lasso_path_sharded(
                X, y, lams, mesh, options=opts, standardize_X=False,
                path_batch=0)),
            ("par_batched", batched),
            ("par_sqrt", lambda: par.sqrt_lasso_sharded(X, y, lam_sq, mesh,
                                                        options=opts_sq)),
            ("par_scaled", lambda: par.scaled_lasso_sharded(X, y, lam_sc,
                                                            mesh)),
            ("par_feasible", lambda: par.feasible_lasso_sharded(X, y, lam_sc,
                                                                mesh)),
            ("par_trace", lambda: tcd.lasso_sharded_with_trace(X, y, lam_t,
                                                               mesh))):
        _run(name, fn, lambda: {"stats": dict(stats)})
    del X, y, bp
    torch.cuda.empty_cache()
    gp = group_bench_problem(torch.device("cuda", 0))
    _run("par_group", lambda: par.group_lasso_sharded(
        gp.X, gp.y, gp.lam * (1.0 + 1e-7), gp.G, mesh, options=gp.opts))
    dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        print("profile_paths: needs a CUDA GPU", file=sys.stderr)
        sys.exit(1)
    import coordinatedescent_jl_tpu_torch as tcd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if sys.argv[1:2] == ["--trace-probe"]:
        return trace_probe(int(sys.argv[2]))
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:2] == ["--vc"]:
        return vc_main()
    if sys.argv[1:2] == ["--obs"]:
        return obs_main()
    if sys.argv[1:2] == ["--par"]:
        return par_main()
    bp = bench_problem(torch.device("cuda", 0))
    X, y, lams, opts = bp.X, bp.y, bp.lams, bp.opts
    lam_end = float(lams[-1])
    out = {}

    def scan():
        return tcd.lasso_path(X, y, lams, options=opts, standardize_X=False,
                              path_batch=0)

    def batched():
        out["stats"] = {}
        return tcd.lasso_path(X, y, lams, options=opts, standardize_X=False,
                              path_batch=128, coarse_stride=len(lams) - 1,
                              stats=out["stats"])

    def polish():
        sol = tcd.lasso(X, y, lam_end)
        out["polish"] = tcd.polish_lasso(X, y, sol.x, lam_end)

    n, p = X.shape
    lam_sq = 1.1 * math.sqrt(2 * math.log(p))
    lam_sc = math.sqrt(2 * math.log(p) / n)
    opts_sq = CDOptions(opt_tol=1e-6, max_iter=300, randomize=False,
                        block_size=128)
    g = torch.Generator(device=X.device).manual_seed(1)
    w = 0.5 + torch.rand(n, generator=g, device=X.device)
    lam_w = 0.05 * float(torch.max(torch.abs((w * y) @ X)) / n)
    sols = {}

    def sqrt():
        sols["sqrt"] = tcd.sqrt_lasso(X, y, lam_sq, options=opts_sq,
                                      standardize_X=False).x

    def scaled():
        sols["scaled"] = tcd.scaled_lasso(X, y, lam_sc * (1.0 + 1e-7)).x

    def feasible():
        sols["feasible"] = tcd.feasible_lasso(X, y, lam_sc * (1.0 + 1e-7)).x

    def scaled_lam():
        tcd.scaled_lasso(X, y, lam_sc)

    def feasible_lam():
        tcd.feasible_lasso(X, y, lam_sc)

    def sqrt_polish():
        out["polish"] = tcd.polish_sqrt_lasso(X, y, sols["sqrt"], lam_sq)

    def scaled_polish():
        out["polish"] = tcd.polish_scaled_lasso(X, y, sols["scaled"],
                                                lam_sc * (1.0 + 2e-7))

    def feasible_polish():
        out["polish"] = tcd.polish_feasible_lasso(X, y, sols["feasible"],
                                                  lam_sc * (1.0 + 2e-7))

    def wls():
        tcd.coordinate_descent(torch.zeros(p, device=X.device),
                               tcd.WeightedLSLoss(y, X, w),
                               tcd.ProxL1(lam_w), opts)

    def fields(name):
        rec = {}
        if name == "batched":
            rec["refine_rounds"] = out["stats"]["refine_rounds"]
        if name.endswith("polish"):
            rec["polish_rounds"] = out["polish"].rounds
            rec["converged"] = out["polish"].converged
        if name in ("polish", "sqrt_polish"):
            rec["support"] = out["polish"].support_size
        if name == "group_polish":
            rec["support_groups"] = out["polish"].support_groups
            rec["kkt_rel"] = out["polish"].kkt_rel
        return rec

    def run(name, fn):
        _run(name, fn, lambda: fields(name))

    for name, fn in (("scan", scan), ("batched", batched),
                     ("polish", polish), ("sqrt", sqrt),
                     ("sqrt_polish", sqrt_polish), ("scaled", scaled),
                     ("scaled_polish", scaled_polish),
                     ("feasible", feasible),
                     ("feasible_polish", feasible_polish),
                     ("scaled_lam", scaled_lam),
                     ("feasible_lam", feasible_lam), ("wls", wls)):
        run(name, fn)

    # the group runs on their own design, the bench design freed first
    del X, y, bp, w, sols
    torch.cuda.empty_cache()
    gp = group_bench_problem(torch.device("cuda", 0))
    lam_g = gp.lam * (1.0 + 1e-7)

    def group():
        sols["group"] = tcd.group_lasso(gp.X, gp.y, lam_g, gp.G,
                                        options=gp.opts).x

    def group_polish():
        out["polish"] = tcd.polish_group_lasso(gp.X, gp.y, sols["group"],
                                               lam_g, gp.G)

    sols = {}
    run("group", group)
    run("group_polish", group_polish)


if __name__ == "__main__":
    main()
