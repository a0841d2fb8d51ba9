"""Where the time goes on the port's main paths, on one GPU.

    python -m coordinatedescent_jl_tpu_torch.profile_paths

On the bench problem (:func:`bench_problem`, which ``chip_smoke.py``
drives too), each path is run once to warm up, once unprofiled for its
wall time and counters, then once under ``torch.profiler`` (CPU + CUDA):

- ``scan``: the 100-point ``lasso_path`` (``path_batch=0``);
- ``batched``: the same grid with ``path_batch=128, coarse_stride=99``;
- ``polish``: ``lasso`` at 0.05·λmax (default options) + ``polish_lasso``.

For each it prints one JSON line: the wall time, the device time (the
sum of the kernels' durations in the trace), the device's idle share,
the number of device kernels, the top kernels by time, the device time
and calls of each of the port's own kernels (``cdt``), the host reads
and the kernel launch counters.  The batched line adds the refine rounds
(``stats``) and the kernels and device time inside the
``union_block_fista`` spans; the polish line adds its rounds and support
(``PolishResult``).  The line before them gives the card's name and power
limit.  Needs a CUDA GPU.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .utils.options import CDOptions

_SPAN = "union_block_fista"   # lasso_path._refine_chunk's profiler span


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
    # the span's device-side annotation is a range, not a kernel
    dev_evs = [e for e in evs
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name != _SPAN]
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


def main():
    if not torch.cuda.is_available():
        print("profile_paths: needs a CUDA GPU", file=sys.stderr)
        sys.exit(1)
    import coordinatedescent_jl_tpu_torch as tcd
    from .kernels import active_pass, check, gradient_sweep as gs
    from .utils import host

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
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

    for name, fn in (("scan", scan), ("batched", batched),
                     ("polish", polish)):
        fn()                                          # warm-up
        active_pass.LAUNCHES = active_pass.LAUNCHES_F64 = gs.LAUNCHES = 0
        check.LAUNCHES_A = check.LAUNCHES_B = 0
        gs.LAUNCHES_DENSE = gs.LAUNCHES_F64 = 0
        host.reset()
        _, wall = _timed(fn)
        rec = {"path": name, "wall_s": wall, **dict(host.COUNTS),
               "launches": {"K1": active_pass.LAUNCHES,
                            "K1f64": active_pass.LAUNCHES_F64,
                            "K2": gs.LAUNCHES, "K3": check.LAUNCHES_A,
                            "K4": check.LAUNCHES_B, "K5": gs.LAUNCHES_DENSE,
                            "K5f64": gs.LAUNCHES_F64}}
        if name == "batched":
            rec["refine_rounds"] = out["stats"]["refine_rounds"]
        if name == "polish":
            rec["polish_rounds"] = out["polish"].rounds
            rec["support"] = out["polish"].support_size
        rec.update(_trace(fn))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
