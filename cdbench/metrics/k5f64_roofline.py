"""K5's float64-accumulating sweep (``grad_f64``: float32 X, float64 r
and output; ``csrc/dense_sweep.cu``) against its roofline over the traced
problems, in %: Σ over the port's ``cdt#k5f64 n= p= x_item=`` marks of
the least time the shape allows (``roofline.py``: X read once, r read and
the gradient written once in float64; one multiply and one add an element
of X) ÷ Σ the device time of its kernels in the trace (the sweep and,
where rows split outside a cluster, the reduction that follows it).
None where a traced problem's marks and kernels differ in count."""

import re

from .. import program_spans, roofline

_SWEEP = re.compile(r"\bsweep_kernel<float, double\b")
_REDUCE = re.compile(r"\bsweep_reduce_kernel<double>")
F64 = 8


def least_seconds(m: dict) -> float:
    n, p = m["n"], m["p"]
    return roofline.least_seconds(n * p * m["x_item"] + F64 * (n + p),
                                  2 * n * p)


def read(rec):
    least = secs = 0.0
    launches = 0
    for tp, _ in rec["traced"]:
        ms = program_spans.marks(tp, "k5f64")
        ops = sorted(tp.ops, key=lambda o: o[1])
        ks = [i for i, (name, _, _) in enumerate(ops) if _SWEEP.search(name)]
        if len(ks) != len(ms):
            return None
        for i in ks:
            secs += (ops[i][2] - ops[i][1]) * 1e-6
            if i + 1 < len(ops) and _REDUCE.search(ops[i + 1][0]):
                secs += (ops[i + 1][2] - ops[i + 1][1]) * 1e-6
        least += sum(least_seconds(m) for m in ms)
        launches += len(ks)
    if not launches or secs <= 0:
        return None
    return 100.0 * least / secs
