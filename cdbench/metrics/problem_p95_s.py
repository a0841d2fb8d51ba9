"""The 95th percentile (nearest rank) of every window problem's host-clock
seconds; a problem its certificate failed counts as infinitely slow, and
a percentile that lands on one is not a number (None)."""

import math


def read(rec):
    t = sorted(p.seconds if p.certified else math.inf
               for p in rec["problems"])
    if not t:
        return None
    v = t[math.ceil(0.95 * len(t)) - 1]
    return v if math.isfinite(v) else None
