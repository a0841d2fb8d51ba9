"""The share of the window's problems, in %, whose batched execution did
not certify every point and that the entry point solved again by its
sequential scan (``stats["batched_certified"]`` false)."""


def read(rec):
    ps = rec["problems"]
    if not ps or any("scan_fallbacks" not in p.counts for p in ps):
        return None
    return 100.0 * sum(p.counts["scan_fallbacks"] for p in ps) / len(ps)
