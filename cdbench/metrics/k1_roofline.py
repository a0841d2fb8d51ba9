"""K1, the fused active pass (``csrc/active_pass.cu``), against its
roofline over the traced problems, in %: Σ over the port's ``cdt#k1``
marks of the least time the blocks each launch visits allow
(:func:`k1_bytes`, :func:`k1_flops`; ``roofline.py``'s peaks) ÷ Σ the
device time of the ``active_pass_kernel`` launches in the trace.  The
visited blocks are the active ones, which the port counts after the entry
point returns (``cdt#counted``, ``cdbench/counted.py``): a pass handed a
whole design that holds few active blocks reads only those.  None where a
traced problem's marks, counts and kernels differ in number."""

import re

from .. import counted, roofline

_K1 = re.compile(r"\bactive_pass_kernel\b")


def k1_bytes(active: int, n: int, B: int = 128, item: int = roofline.F32,
             gram: bool = True) -> int:
    """One pass of the ls kind (the kind the cells that report this metric
    run) that visits ``active`` blocks of ``n`` rows and ``B`` columns:
    each visited block's X_b and cached Gram read, its lamw and beta read
    and beta written (three B-long rows a block), r read and written."""
    return item * (active * n * B + (active * B * B if gram else 0)
                   + 3 * active * B + 2 * n)


def k1_flops(active: int, n: int, B: int = 128, iters: int = 16,
             gram: bool = True) -> int:
    """Per visited block: ``c = X_b'r`` and ``r -= X_b Δβ`` (2nB each),
    ``iters`` FISTA steps of a B x B product (2B² each), or for the exact
    scan (``iters`` 0) one pass of the Gram recursion (2B²) and ~40
    operations a coordinate; without a cached Gram, ``X_b'X_b`` (2nB²)."""
    solve = 2 * iters * B * B if iters else 2 * B * B + 40 * B
    return active * (4 * n * B + solve + (0 if gram else 2 * n * B * B))


def least_seconds(m: dict) -> float:
    """A ``cdt#k1`` mark with its count of visited blocks."""
    gram = bool(m["gram"])
    return roofline.least_seconds(
        k1_bytes(m["count"], m["n"], m["B"], m["x_item"], gram),
        k1_flops(m["count"], m["n"], m["B"], m["iters"], gram))


def read(rec):
    least = secs = 0.0
    launches = 0
    for tp, _ in rec["traced"]:
        ms = counted.marks(tp, "k1")
        ks = [(s, e) for name, s, e in tp.ops if _K1.search(name)]
        if ms is None or len(ks) != len(ms):
            return None
        secs += sum(e - s for s, e in ks) * 1e-6
        least += sum(least_seconds(m) for m in ms)
        launches += len(ks)
    if not launches or secs <= 0:
        return None
    return 100.0 * least / secs
