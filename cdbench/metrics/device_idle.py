"""The device's idle share over the traced problems, in %: 1 − the union
of the device operations' intervals ÷ the traced stretches (each problem's
span, widened to its operations)."""

from .. import trace


def read(rec):
    tps = [tp for tp, _ in rec["traced"]]
    win = sum(tp.end - tp.start for tp in tps)
    if not tps or win <= 0:
        return None
    return 100.0 * (1.0 - sum(trace.busy_us(tp) for tp in tps) / win)
