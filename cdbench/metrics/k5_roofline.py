"""K5, the blocked dense gradient sweep (``csrc/dense_sweep.cu``), against
its roofline over the traced problems, in %: Σ over its launches of the
least time their shape allows (``roofline.py``; shapes from the wrapper's
``LAUNCHES_DENSE_SHAPE``) ÷ Σ the device time of its float32 kernels in
the trace (the sweep and, where rows split outside a cluster, its
reduction).  None where the trace's launches are not the counter's (a
float64 blocked sweep, whose shapes the counter does not tell apart)."""

import re

from .. import roofline
from . import block_size

_SWEEP = re.compile(r"\bsweep_kernel<float, float\b")
_PART = re.compile(r"\bsweep_kernel<float, float\b|\bsweep_reduce_kernel<float>")


def read(rec):
    B = block_size(rec)
    least = secs = 0.0
    launches = 0
    for tp, d in rec["traced"]:
        shapes = d["k5_shapes"]
        n_seen = sum(1 for name, _, _ in tp.ops if _SWEEP.search(name))
        if n_seen != sum(shapes.values()):
            return None
        launches += n_seen
        secs += sum(e - s for name, s, e in tp.ops
                    if _PART.search(name)) * 1e-6
        least += sum(c * roofline.least_seconds(
            roofline.k5_bytes(nb, n, B), roofline.k5_flops(nb, n, B))
            for (nb, n), c in shapes.items())
    if not launches or secs <= 0:
        return None
    return 100.0 * least / secs
