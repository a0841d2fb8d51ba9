"""The counts the port takes after the fact: a mark given ``later=`` in
``utils/host.py`` (``cdt#k1``, ``cdt#union``) keeps a device tensor, and
when the outermost entry point returns one range ``cdt#counted
<kind>=c,c,...`` carries the positive entries of each, a kind's in the
order of its marks.  A tree that opens no such range gives no count."""

from __future__ import annotations

from . import program_spans

COUNTED = program_spans.MARK + "counted"


def _in_order(tp):
    return tp._replace(host=sorted(tp.host, key=lambda h: h[1]))


def counts(tp, kind: str) -> list:
    """The counts of ``kind``'s marks in a traced problem, in time order."""
    out = []
    for name, _, _ in _in_order(tp).host:
        head, *pairs = name.split(" ")
        if head != COUNTED:
            continue
        for q in pairs:
            k, v = q.split("=", 1)
            if k == kind:
                out += [int(c) for c in v.split(",")]
    return out


def marks(tp, kind: str) -> list | None:
    """``kind``'s marks in time order, each with its count under
    ``"count"``; None where the marks and the counts differ in number."""
    ms = program_spans.marks(_in_order(tp), kind)
    cs = counts(tp, kind)
    if len(ms) != len(cs):
        return None
    return [{**m, "count": c} for m, c in zip(ms, cs)]
