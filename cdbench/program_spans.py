"""The port's own profiler ranges in a traced problem, and the device's
idle time split among them.

The port (``utils/host.py``) opens a ``record_function`` range at its
layer boundaries while a profiler runs: spans ``cdt:<layer>.<phase>``
(``cd.full_check``, ``path.refine_round``, ``polish.certify``, ...) and
marks ``cdt#<kind> k=v ...`` around one launch or one copy
(``cdt#k5f64 n= p= x_item=``, ``cdt#design_copy bytes=``).  They are host
events of the trace (``TracedProblem.host``), on the device operations'
clock.  A tree whose port opens none (an older one) gives None here.

Idle self time: each idle interval of the device (``trace.gaps``) is cut
at the spans' edges, and each piece belongs to the innermost span that
holds it (the shortest); marks own no idle.  The pieces of all spans and
the idle under no span add up to the traced idle.
"""

from __future__ import annotations

from . import trace

SPAN = "cdt:"
MARK = "cdt#"
_KERNEL_NS = "cdt::"       # the port's kernels' own C++ namespace


def spans(tp: trace.TracedProblem) -> list:
    """``(name, start_us, end_us)`` of the port's spans, the name without
    its ``cdt:`` prefix."""
    return [(name[len(SPAN):], s, e) for name, s, e in tp.host
            if name.startswith(SPAN) and not name.startswith(_KERNEL_NS)]


def marks(tp: trace.TracedProblem, kind: str) -> list:
    """The attributes of each ``kind`` mark, ``{key: int}``, in the
    trace's order."""
    out = []
    for name, _, _ in tp.host:
        if not name.startswith(MARK):
            continue
        head, *pairs = name.split(" ")
        if head == MARK + kind:
            out.append({k: int(v) for k, v in (q.split("=", 1)
                                                for q in pairs)})
    return out


def instrumented(traced) -> bool:
    """Whether the traced problems hold any of the port's ranges."""
    return any(name.startswith((SPAN, MARK))
               and not name.startswith(_KERNEL_NS)
               for tp in traced for name, _, _ in tp.host)


def _owners(sp) -> list:
    """The spans' edges cut time into segments: ``(start, end, owner)``
    for each, ``owner`` the innermost span covering it (None where no span
    does), in time order."""
    bounds = sorted({t for _, s, e in sp for t in (s, e)})
    by_start = sorted(sp, key=lambda x: x[1])
    out, active, j = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while j < len(by_start) and by_start[j][1] <= a:
            active.append(by_start[j])
            j += 1
        active = [x for x in active if x[2] >= b]
        owner = min(active, key=lambda x: x[2] - x[1])[0] if active else None
        out.append((a, b, owner))
    return out


def idle_by_span(tp: trace.TracedProblem):
    """``(owned, unowned)``: the device's idle µs in the problem by the
    span that owns it (``{name: µs}``), and the idle µs under no span."""
    segs = _owners(spans(tp))
    owned, unowned = {}, 0.0
    k = 0
    for gs, ge in trace.gaps(tp):
        covered = 0.0
        while k < len(segs) and segs[k][1] <= gs:
            k += 1
        i = k
        while i < len(segs) and segs[i][0] < ge:
            a, b, owner = segs[i]
            piece = min(b, ge) - max(a, gs)
            if piece > 0 and owner is not None:
                owned[owner] = owned.get(owner, 0.0) + piece
                covered += piece
            i += 1
        unowned += (ge - gs) - covered
    return owned, unowned


def idle_ms(rec, owns) -> float | None:
    """The idle a traced problem spends under spans that ``owns(name)``
    picks, in ms, averaged over the traced problems; None where the traces
    hold none of the port's ranges."""
    tps = [tp for tp, _ in rec["traced"]]
    if not tps or not instrumented(tps):
        return None
    tot = 0.0
    for tp in tps:
        owned, _ = idle_by_span(tp)
        tot += sum(us for name, us in owned.items() if owns(name))
    return tot * 1e-3 / len(tps)
