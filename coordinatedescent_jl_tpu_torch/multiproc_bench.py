"""Strong scaling of the feature-sharded Lasso over worlds of spawned ranks
(counterpart of ``tools/multiproc_bench.py``).

    python -m coordinatedescent_jl_tpu_torch.multiproc_bench         # cards
    python -m coordinatedescent_jl_tpu_torch.multiproc_bench --cpu   # CPU

The same global problem (n = 10,000, p = 16,384, s = 50 planted
coefficients, numpy seed 11, float32, λ = 0.1·λmax, ``opt_tol=1e-6``,
``randomize=False``) is solved by ``parallel.lasso_sharded`` on worlds of
1, 2 and 4 spawned ranks (``parallel.distributed.World``), each rank
pinned to one core of this process's affinity set
(``os.sched_setaffinity`` and ``torch.set_num_threads(1)``).

- By default each rank owns one card (NCCL, ``cuda:<rank>``); the worlds
  are those of 1, 2 and 4 that the machine's cards allow (one card: the
  world of one alone, and no efficiency).  Without a card it raises.
- ``--cpu`` (``device="cpu"``) is the original's measurement: Gloo ranks
  on the host's cores.  There the pinning is the validity condition
  (tools/multiproc_bench.py:12-20): an unpinned world of one would already
  use every core, and the ratio would show no gain by construction; with
  one core a rank, the compute of a rank is constant and the ratio
  isolates communication and sharding overhead.

    efficiency(k) = T_1 / (k · T_k)          (strong scaling)

``T_k`` is the least of 3 timed solves (λ nudged by ``1e-7·(rep + 1)``;
on the cards a ``torch.cuda.synchronize()`` before each clock read) after
one warm-up solve.  The collective accounting is
``parallel/_collectives.COUNTS`` over rank 0's last timed solve (calls and
bytes by kind), in place of the original's scan of the compiled program's
collectives.  Each world's solution at the last λ is held against the
world of one's.

Prints one JSON line: ``device`` (``"cuda"`` or ``"cpu"``), ``efficiency``
the 2-rank value (bench.py's ``multiproc_efficiency``, absent without a
2-rank world), ``curve`` every world's time, speedup, efficiency and
collectives.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from .utils.options import CDOptions


def problem(n: int, p: int, s: int, seed: int, dtype):
    """The global problem, the same bits in every rank, on the host:
    Gaussian X (float32 draws), ``s`` scattered planted Gaussian
    coefficients, noise 0.3, λ = 0.1·max|X'y|/n."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p), dtype=np.float32)
    b = np.zeros(p, np.float32)
    b[rng.choice(p, s, replace=False)] = rng.standard_normal(s)
    y = X @ b + 0.3 * rng.standard_normal(n).astype(np.float32)
    X = torch.as_tensor(X).to(dtype)
    y = torch.as_tensor(y).to(dtype)
    return X, y, 0.1 * float(torch.max(torch.abs(y @ X))) / n


def _rank(n, p, s, seed, dtype, opt_tol, reps, cores, device):
    """One rank: pinned to its core (and on the cards to ``cuda:<rank>``),
    one warm-up solve, then ``reps`` timed ones; the least time, the
    warm-up's nonzeros, the last solution and the last solve's
    collectives."""
    import torch.distributed as dist

    from . import parallel as par
    from .parallel import _collectives
    from .parallel import distributed as pdist

    rank = dist.get_rank()
    os.sched_setaffinity(0, {cores[rank % len(cores)]})
    torch.set_num_threads(1)
    if device == "cpu":
        dev = torch.device("cpu")
    else:                               # one card a rank
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    X, y, lam = problem(n, p, s, seed, dtype)
    X, y = X.to(dev), y.to(dev)
    mesh = pdist.feature_mesh()
    opts = CDOptions(opt_tol=opt_tol, randomize=False)

    def solve(lam0):
        sol = par.lasso_sharded(X, y, lam0, mesh, options=opts, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return sol

    nnz = int((solve(lam).x != 0).sum())
    best = math.inf
    for rep in range(reps):
        _collectives.reset()
        t0 = time.perf_counter()
        sol = solve(lam * (1.0 + 1e-7 * (rep + 1)))
        best = min(best, time.perf_counter() - t0)
    return {"t_solve": best, "nnz": nnz, "x": sol.x.cpu().numpy(),
            "collectives": {k: {"calls": c, "bytes": b} for k, (c, b)
                            in _collectives.COUNTS.items()}}


def card_worlds(worlds=(1, 2, 4)) -> tuple:
    """The worlds of ``worlds`` this machine's cards allow, one card a
    rank."""
    return tuple(k for k in worlds if k <= torch.cuda.device_count())


def run(n: int = 10_000, p: int = 16_384, s: int = 50, worlds=(1, 2, 4),
        reps: int = 3, dtype=torch.float32, opt_tol: float = 1e-6,
        seed: int = 11, timeout: float = 1800.0, device=None) -> dict:
    """The scaling curve over ``worlds`` (the first must be 1); returns the
    result record (the module docstring).  ``device`` ``None`` or
    ``"cuda"``: one card a rank on NCCL (raises without the cards the
    largest world needs); ``"cpu"``: Gloo ranks on the host's cores."""
    from .parallel.distributed import World

    if worlds[0] != 1:
        raise ValueError("the first world must be the world of one")
    device = "cuda" if device is None else torch.device(device).type
    if device == "cuda":
        if torch.cuda.device_count() < max(worlds):
            raise RuntimeError(
                f"multiproc_bench: a world of {max(worlds)} ranks needs as "
                f"many CUDA devices, this machine has "
                f"{torch.cuda.device_count()} (device='cpu' runs the Gloo "
                f"worlds on the host's cores)")
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"multiproc_bench: no such device type {device!r}")
    cores = sorted(os.sched_getaffinity(0))
    res = {}
    for k in worlds:
        ranks = World(_rank, k, (n, p, s, seed, dtype, opt_tol, reps, cores,
                                 device),
                      backend=backend, timeout=timeout).wait()
        res[k] = ranks[0]
    t1 = res[1]["t_solve"]
    curve = {str(k): {"t_s": round(r["t_solve"], 4),
                      "speedup": round(t1 / r["t_solve"], 3),
                      "efficiency": round(t1 / (k * r["t_solve"]), 3),
                      "nnz": r["nnz"],
                      "max_abs_diff_vs_1": float(np.max(np.abs(
                          r["x"].astype(np.float64) - res[1]["x"]))),
                      "collectives": r["collectives"]}
             for k, r in res.items()}
    out = {"shape": {"n": n, "p": p, "s": s},
           **{f"t_{k}proc_s": curve[str(k)]["t_s"] for k in worlds},
           "curve": curve,
           "nnz_agree": len({r["nnz"] for r in res.values()}) == 1,
           "cores_per_worker": 1, "cores": len(cores), "device": device}
    if device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    if 2 in res:
        out["speedup"] = curve["2"]["speedup"]
        out["efficiency"] = curve["2"]["efficiency"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="Gloo ranks on the host's cores (default: one card "
                         "a rank; raises without a card)")
    ap.add_argument("--small", action="store_true",
                    help="n = 500, p = 2,048, one timed solve")
    args = ap.parse_args(argv)
    kw = dict(n=500, p=2048, s=10, reps=1) if args.small else {}
    if args.cpu:
        out = run(device="cpu", **kw)
    else:
        if not torch.cuda.is_available():
            raise SystemExit("multiproc_bench: no CUDA device (pass --cpu "
                             "for the Gloo worlds on the host's cores)")
        out = run(device="cuda", worlds=card_worlds(), **kw)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
