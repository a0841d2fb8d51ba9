"""Reading one traced problem out of ``torch.profiler``.

A traced problem is one profiler session around one whole problem
(CPU + CUDA activities).  The tracer now and then drops a kernel's record
(Kineto logs it "Out-of-range"); the port's wrappers count their own
launches, so a trace that shows fewer of a port kernel than its wrapper
launched is incomplete, and the harness traces another problem in its
place.

From a complete trace: the device operations (name, start, end in µs on
the profiler's clock), the harness's own spans (``record_function``
ranges named ``cdbench:<name>``) and, for the idle gaps, the innermost
host operation under which each gap fell.
"""

from __future__ import annotations

import collections
import re
from typing import NamedTuple

SPAN_PREFIX = "cdbench:"

# the port's kernels by their (demangled) device names, and the wrapper
# counter each must match in a complete trace
_PORT_KERNELS = {
    "K1": re.compile(r"\bactive_pass_kernel\b"),
    "K2": re.compile(r"\brsweep_partial_kernel\b"),
    "K3": re.compile(r"\bcheck_a_(kernel|cta)\b"),
    "K4": re.compile(r"\bcheck_b_(kernel|cta)\b"),
    "K5": re.compile(r"\bsweep_kernel<(float, float|double, double)"),
    "K5f64": re.compile(r"\bsweep_kernel<float, double"),
}


# the tracer's own host events (CUPTI's buffer requests): not the program's
_TRACER_OWN = ("Activity Buffer",)


class TracedProblem(NamedTuple):
    ops: list          # (name, start_us, end_us) of every device operation
    spans: list        # (name, start_us, end_us) of the harness's spans
    host: list         # (name, start_us, end_us) of every host operation
    start: float       # the stretch: the problem's span, widened to its ops
    end: float


def port_kernel_counts(ops) -> dict:
    out = collections.Counter()
    for name, _, _ in ops:
        for key, pat in _PORT_KERNELS.items():
            if pat.search(name):
                out[key] += 1
    return out


def complete(ops, counted: dict) -> bool:
    """Every port kernel the wrappers counted shows in the trace."""
    seen = port_kernel_counts(ops)
    return all(seen[k] >= v for k, v in counted.items())


def read(prof, counted: dict, problem_span: str) -> TracedProblem | None:
    """The problem's record, or None when the trace lost a counted
    kernel."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    # a record_function range shows on the device side too, under its host
    # name: an annotation, not an operation
    host_names = {e.name for e in events if e.device_type != cuda}
    ops, spans, host = [], [], []
    for e in events:
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type == cuda:
            if e.name not in host_names:
                ops.append((e.name, *rng))
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name[len(SPAN_PREFIX):], *rng))
        elif not e.name.startswith(_TRACER_OWN):
            host.append((e.name, *rng))
    if not complete(ops, counted):
        return None
    whole = [s for s in spans if s[0] == problem_span]
    if len(whole) != 1:
        return None
    start, end = whole[0][1], whole[0][2]
    if ops:
        start = min(start, min(o[1] for o in ops))
        end = max(end, max(o[2] for o in ops))
    return TracedProblem(ops, spans, host, start, end)


def merged(ops):
    """The union of the operations' intervals, as sorted disjoint
    ``(start, end)`` pairs."""
    out = []
    for s, e in sorted((o[1], o[2]) for o in ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(tp: TracedProblem) -> float:
    return sum(e - s for s, e in merged(tp.ops))


def gaps(tp: TracedProblem):
    """The device's idle intervals inside the stretch, ``(start, end)``."""
    out, t = [], tp.start
    for s, e in merged(tp.ops):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if tp.end > t:
        out.append((t, tp.end))
    return out


def _innermost(events, t):
    """The shortest of ``events`` whose range holds time ``t``."""
    best = None
    for name, s, e in events:
        if s <= t <= e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best


def label(tp: TracedProblem, t: float, problem_span: str) -> str:
    """What the host was doing at ``t``: the innermost harness span below
    the whole problem, then the innermost host operation."""
    inner = [s for s in tp.spans if s[0] != problem_span]
    sp = _innermost(inner, t)
    op = _innermost(tp.host, t)
    where = sp[0] if sp else ("between calls" if _innermost(
        tp.spans, t) else "between problems")
    return f"{where}: {op[0] if op else 'python'}"


def breakdown(traced, problem_span: str, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps labelled by what the host was doing, over all traced problems
    (seconds)."""
    by_name = collections.Counter()
    for tp in traced:
        for name, s, e in tp.ops:
            by_name[name] += (e - s) * 1e-6
    gap_list = []
    for tp in traced:
        for s, e in gaps(tp):
            gap_list.append((e - s, tp, 0.5 * (s + e)))
    gap_list.sort(key=lambda g: -g[0])
    return {"device_ops": [[name[:160], secs] for name, secs
                           in by_name.most_common(top)],
            "idle_gaps": [[label(tp, mid, problem_span), dur * 1e-6]
                          for dur, tp, mid in gap_list[:top]]}
