"""The feasible Lasso's loadings sweeps (``get_loadings_blocked`` in the
float32 rounds, ``loadings_f64`` in the polish) against their roofline
over the traced problems, in %: Σ over the port's ``cdt#loadings n= p=
x_item= acc=`` marks of the least time the shape allows (X read once, the
residual read and the loadings written once in the accumulation's
precision; a square, a multiply and an add an element of X) ÷ Σ the
device time of the operations that start inside the port's
``feasible.loadings`` and ``polish.loadings`` spans (the sweep, with the
residual and the read that the span holds besides).  None where a traced
problem's marks and spans differ in count."""

from .. import program_spans, roofline

SPANS = ("feasible.loadings", "polish.loadings")
# float64 on the tensor cores (NVIDIA H100 SXM data sheet, dense, 700 W)
PEAK_F64_FLOPS = 67e12
F64 = 8


def least_seconds(m: dict) -> float:
    n, p, acc = m["n"], m["p"], m["acc"]
    nbytes = m["x_item"] * n * p + acc * (n + p)
    flops = 3 * n * p
    if acc == F64:
        return max(nbytes / roofline.PEAK_BYTES_PER_S,
                   flops / PEAK_F64_FLOPS)
    return roofline.least_seconds(nbytes, flops)


def read(rec):
    least = secs = 0.0
    sweeps = 0
    for tp, _ in rec["traced"]:
        ms = program_spans.marks(tp, "loadings")
        sp = [(s, e) for name, s, e in program_spans.spans(tp)
              if name in SPANS]
        if len(ms) != len(sp):
            return None
        secs += sum(oe - os for _, os, oe in tp.ops
                    if any(s <= os <= e for s, e in sp)) * 1e-6
        least += sum(least_seconds(m) for m in ms)
        sweeps += len(ms)
    if not sweeps or secs <= 0:
        return None
    return 100.0 * least / secs
