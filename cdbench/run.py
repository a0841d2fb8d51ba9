"""One run of one cell of the port's benchmark.

    python3 -m cdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds ``BENCHMARK.json``, this
folder and the port (``coordinatedescent_jl_tpu_torch``).  Everything is
found by name: the cell in ``BENCHMARK.json``; its configuration in the
file that entry names; its traffic mix in ``cdbench/traffic/<mix>.json``,
whose ``task`` names the code that drives the port
(``cdbench/tasks/<task>.py``) and the plain reference that judges it
(``cdbench/reference/<task>.py``); each metric in
``cdbench/metrics/<metric>.py``.

A run: set-up (find the card or fail, make the design and a pool of
responses on the card from the seed, work out each problem's penalty,
solve one problem of the cell's kind to build and warm every kernel),
then a closed loop of one caller solving problems back to back for
``--seconds`` (with ``--trace 1``, a fixed number of whole problems in
it are traced, one profiler session each), then the comparison of the
kept outputs with the reference, then one JSON line on standard output.
With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()
# one caller, few host threads: the port's host-side NumPy and PyTorch CPU
# work is small, and a pool of threads a core only adds jitter
for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = "coordinatedescent_jl_tpu_torch"
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "coordinatedescent_jl_tpu")
PROBLEM_SPAN = "problem"


class Problem(NamedTuple):
    index: int          # position in the window
    seconds: float      # host wall, ending in a synchronize
    certified: bool     # by the program's own certificate
    spans: dict         # the harness's spans inside it, seconds by name
    counts: dict        # counts the entry point returned (stats)


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def resolve(spec: dict, workload: str, root: Path = ROOT):
    """The cell, its configuration and its traffic mix, by name."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"cdbench: no workload {workload!r} in "
                         f"BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    cfgs = {c["name"]: c for c in spec["configs"]}
    cfg = load_json(root / cfgs[cell["config"]]["file"])
    traffic = load_json(root / "cdbench" / "traffic"
                        / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def metrics_for(spec: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that the cell
    reports."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Spans:
    """The harness's spans around the calls into the port: a host-clock
    duration each (the span ends in a synchronize, so the time is the
    device's too) and a ``record_function`` range a profiler can see."""

    def __init__(self, dev):
        import torch

        self._torch = torch
        self._sync = (torch.cuda.synchronize if dev.type == "cuda"
                      else (lambda: None))
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = self._torch.profiler.record_function(f"cdbench:{name}")
        rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
            self._sync()
        finally:
            self.times[name] = (self.times.get(name, 0.0)
                                + time.perf_counter() - t0)
            rf.__exit__(None, None, None)


def launch_counters() -> dict:
    """The port's wrapper launch counters, by the trace's kernel keys."""
    from coordinatedescent_jl_tpu_torch.kernels import (active_pass, check,
                                                        gradient_sweep)

    return {"K1": sum(sum(v) for v in active_pass.LAUNCHES_KIND.values()),
            "K2": gradient_sweep.LAUNCHES, "K3": check.LAUNCHES_A,
            "K4": check.LAUNCHES_B, "K5": gradient_sweep.LAUNCHES_DENSE,
            "K5f64": gradient_sweep.LAUNCHES_F64,
            "k5_shapes": dict(gradient_sweep.LAUNCHES_DENSE_SHAPE),
            "check_shapes": dict(check.LAUNCHES_SHAPE)}


def _delta(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            d = {s: c - before[k].get(s, 0) for s, c in v.items()}
            out[k] = {s: c for s, c in d.items() if c}
        else:
            out[k] = v - before[k]
    return out


def _port_from_checkout(root: Path):
    mod = importlib.import_module(PORT)
    where = Path(mod.__file__).resolve()
    if root not in where.parents:
        raise SystemExit(f"cdbench: {PORT} was imported from {where}, not "
                         f"from the checkout at {root}")


def run_cell(cell: dict, cfg: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, dev, t_start: float,
             root: Path = ROOT) -> dict:
    """Set-up, window and comparison of one run; returns the run's record
    (what the metric readers read)."""
    import torch

    from . import data
    from . import trace as tracemod

    _port_from_checkout(root)
    from coordinatedescent_jl_tpu_torch.utils import host

    # the kernels' library: loaded from the checkout's build directory, or
    # built there by nvcc in a checkout's first run (part of the set-up;
    # its seconds are printed apart as well)
    build_s = 0.0
    if dev.type == "cuda":
        from coordinatedescent_jl_tpu_torch.kernels import _build

        t_lib = time.perf_counter()
        _build.library()
        build_s = _build.build_seconds
        log(f"cdbench: kernel library ready in "
            f"{time.perf_counter() - t_lib:.3f} s (nvcc build {build_s:.3f} s)")

    task = importlib.import_module(f"cdbench.tasks.{traffic['task']}")
    ref = importlib.import_module(f"cdbench.reference.{traffic['task']}")
    state = task.prepare(cfg, traffic, seed, dev)
    pool = state.pool
    spans = Spans(dev)
    task.solve(state, pool, spans)          # the warm-up problem
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        if trace:
            # the tracer's own start-up (CUPTI), outside the window
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                torch.ones((1,), device=dev).add_(1)
                torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    log(f"cdbench: set-up {setup_s:.3f} s")

    chk = traffic["check"]
    keep = set(data.sample_indices(seed, chk["span"], chk["problems"]))
    n_trace = int(traffic["trace_problems"]) if trace else 0
    tries, traced = 0, []
    problems, kept, last = [], {}, None
    reads0 = host.COUNTS["host_reads"]
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        more_trace = len(traced) < n_trace and tries < 3 * n_trace
        if i and time.perf_counter() >= deadline and not more_trace:
            break
        if i == pool:
            log(f"cdbench: the pool of {pool} responses ran out: problems "
                f"repeat from here")
        k = i % pool
        spans.times = {}
        tracing = more_trace and i >= 1
        prof = None
        if tracing:
            from torch.profiler import ProfilerActivity, profile

            before = launch_counters()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        ts = time.perf_counter()
        with spans(PROBLEM_SPAN):
            oc = task.solve(state, k, spans)
        te = time.perf_counter()
        if tracing:
            prof.__exit__(None, None, None)
            tries += 1
            d = _delta(launch_counters(), before)
            counted = {key: v for key, v in d.items()
                       if not isinstance(v, dict)}
            tp = tracemod.read(prof, counted, PROBLEM_SPAN)
            if tp is None:
                log(f"cdbench: the trace of problem {i} lost a kernel's "
                    f"record; tracing another")
            else:
                traced.append((tp, d))
        problems.append(Problem(i, te - ts, bool(oc.certified),
                                dict(spans.times), dict(oc.counts)))
        if i in keep or oc.uncertified_path:
            kept[i] = (k, oc.output)
        last = (i, k, oc.output)
        i += 1
    t_end = time.perf_counter()
    secs = sorted(p.seconds for p in problems)
    log("cdbench: problem seconds quantiles min p50 p90 p95 max "
        + " ".join(f"{secs[min(len(secs) - 1, int(q * len(secs)))]:.4f}"
                   for q in (0.0, 0.5, 0.9, 0.95, 1.0))
        + f" over {len(secs)}")
    host_reads = host.COUNTS["host_reads"] - reads0
    mem = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the comparison, once the window has closed and the peak is read
    kept[last[0]] = (last[1], last[2])
    t_ref = time.perf_counter()
    per = ref.judge(state, kept)
    ref_s = time.perf_counter() - t_ref
    limits = traffic["limits"]
    bad = {i for i, v in per.items()
           if any(not (v[n] <= lim) for n, lim in limits.items())}
    uncert = {p.index for p in problems if not p.certified}
    checks = {n: {"value": max(v[n] for v in per.values()), "limit": lim}
              for n, lim in limits.items()}
    checks["uncertified"] = {"value": len(uncert), "limit": 0}
    log(f"cdbench: compared {len(per)} problems {sorted(per)} in "
        f"{ref_s:.3f} s")
    return {"setup_s": setup_s, "build_s": build_s, "window_s": t_end - t0,
            "problems": problems, "memory_peak_bytes": mem,
            "host_reads": host_reads, "traced": traced,
            "failed": len(uncert | bad), "checks": checks,
            "correct": not (uncert or bad), "cell": cell, "config": cfg,
            "traffic": traffic, "per_problem": per}


def read_metrics(entries: list, rec: dict) -> dict:
    out = {}
    for m in entries:
        mod = importlib.import_module(f"cdbench.metrics.{m['name']}")
        v = mod.read(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def nvidia_smi() -> dict:
    q = "name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    try:
        res = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"error": str(e)}
    rows = [r.split(", ") for r in res.stdout.strip().splitlines()]
    keys = q.split(",")
    return {"gpus": [dict(zip(keys, r)) for r in rows]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cdbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    cell, cfg, traffic = resolve(spec, args.workload)

    import torch

    if not torch.cuda.is_available():
        log("cdbench: no CUDA device; the benchmark runs only on the card")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"cdbench: {cell['name']} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    # any cache a library may write stays at a fixed path in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi0 = nvidia_smi()
    log("cdbench: nvidia-smi before " + json.dumps(smi0))
    torch.cuda.init()
    torch.empty((0,), device=dev)             # the allocator, before its reset
    torch.cuda.reset_peak_memory_stats(dev)
    rec = run_cell(cell, cfg, traffic, args.seed, args.seconds,
                   bool(args.trace), dev, T_START)
    smi1 = nvidia_smi()
    log("cdbench: nvidia-smi after " + json.dumps(smi1))
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = read_metrics(metrics_for(spec, cell["name"], kind), rec)
    gpu = (smi0.get("gpus") or [{}])[0]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell["chips"],
              "memory_peak_bytes": rec["memory_peak_bytes"],
              "power_limit_w": gpu.get("power.limit"),
              "sm_clock_mhz": gpu.get("clocks.sm"),
              "sm_clock_max_mhz": gpu.get("clocks.max.sm")}
    out = {"correct": rec["correct"], "attempted": len(rec["problems"]),
           "failed": rec["failed"], "metrics": metrics, "device": device}
    if args.trace:
        from . import trace as tracemod

        tps = [tp for tp, _ in rec["traced"]]
        device["busy_s"] = sum(tracemod.busy_us(tp) for tp in tps) * 1e-6
        device["window_s"] = sum(tp.end - tp.start for tp in tps) * 1e-6
        device["traced_problems"] = len(tps)
        out["breakdown"] = tracemod.breakdown(tps, PROBLEM_SPAN)
    # the nvcc build inside setup_s (0 where the checkout had the library)
    out["build_s"] = rec["build_s"]
    out["checks"] = rec["checks"]
    found = forbidden_modules()
    if found:
        log(f"cdbench: the run loaded {found}; the port's benchmark may not")
        return 3
    for name, c in rec["checks"].items():
        log(f"cdbench: check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
