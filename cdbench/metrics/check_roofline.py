"""K3 and K4, the fused full check's two phases (``csrc/check.cu``),
against their roofline over the traced problems, in %: Σ over their
launches of the least time their shape allows (``roofline.py``; shapes
from the wrapper's ``check.LAUNCHES_SHAPE``) ÷ Σ their kernels' device
time in the trace."""

import re

from .. import roofline
from . import block_size

_CHECK = re.compile(r"\bcheck_([ab])_(kernel|cta)\b")


def read(rec):
    B = block_size(rec)
    least = secs = 0.0
    launches = 0
    for tp, d in rec["traced"]:
        shapes = d["check_shapes"]
        ks = [(name, s, e) for name, s, e in tp.ops if _CHECK.search(name)]
        if len(ks) != sum(shapes.values()):
            return None
        launches += len(ks)
        secs += sum(e - s for _, s, e in ks) * 1e-6
        least += sum(c * roofline.least_seconds(
            roofline.check_bytes(ph, nb, B), roofline.check_flops(ph, nb, B))
            for (ph, nb, _), c in shapes.items())
    if not launches or secs <= 0:
        return None
    return 100.0 * least / secs
