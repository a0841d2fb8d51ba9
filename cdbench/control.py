"""The readings a cell's correctness limit is set from.

    python3 -m cdbench.control --workload <cell> --seeds <s> [<s> ...] [--problems k]

For each seed, at the cell's own sizes on the card: the run's set-up and
warm-up, then the first ``k`` of the problems a run would keep for the
comparison, each solved by the program (its readings: the lower end of a
limit) and by the control, the plain reference computed in the lower
precision the traffic mix names (``"control"``) in the program's place
(its readings: the upper end).  Both are judged by the float64 reference
as a run judges.  Prints one JSON line a seed.  The benchmark's runs do
not run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import time

from .run import Spans, load_spec, log, resolve


def readings(cell, cfg, traffic, seed: int, k: int, dev) -> dict:
    from . import data

    task = importlib.import_module(f"cdbench.tasks.{traffic['task']}")
    ref = importlib.import_module(f"cdbench.reference.{traffic['task']}")
    state = task.prepare(cfg, traffic, seed, dev)
    spans = Spans(dev)
    task.solve(state, state.pool, spans)
    chk = traffic["check"]
    idx = data.sample_indices(seed, chk["span"], chk["problems"])[:k]
    prog, ctrl = {}, {}
    t0 = time.perf_counter()
    for i in idx:
        oc = task.solve(state, i % state.pool, spans)
        prog[i] = (i % state.pool, oc.output)
    t1 = time.perf_counter()
    for i in idx:
        k = i % state.pool
        ctrl[i] = (k, ref.control(state, i, k, traffic["control"]))
    t2 = time.perf_counter()
    jp = ref.judge(state, prog)
    jc = ref.judge(state, ctrl)
    t3 = time.perf_counter()
    return {"workload": cell["name"], "seed": seed, "problems": idx,
            "program": jp, "control": jc, "control_spec": traffic["control"],
            "program_s": t1 - t0, "control_s": t2 - t1, "judge_s": t3 - t2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cdbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--problems", type=int, default=2)
    args = ap.parse_args(argv)
    cell, cfg, traffic = resolve(load_spec(), args.workload)

    import torch

    if not torch.cuda.is_available():
        log("cdbench.control: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        rec = readings(cell, cfg, traffic, seed, args.problems, dev)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
