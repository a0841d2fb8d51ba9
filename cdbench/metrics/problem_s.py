"""Seconds of the window per problem completed and certified in it: the
window's host-clock length (its first problem's start to its last
problem's end, each problem ending in a synchronize) over the count."""


def read(rec):
    ok = sum(1 for p in rec["problems"] if p.certified)
    return rec["window_s"] / ok if ok else None
