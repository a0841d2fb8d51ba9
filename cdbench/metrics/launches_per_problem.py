"""Device operations (kernels, copies, fills) in the traces of the traced
problems, per problem: each one the host dispatched."""


def read(rec):
    tps = [tp for tp, _ in rec["traced"]]
    return sum(len(tp.ops) for tp in tps) / len(tps) if tps else None
