"""The bytes the port's problem set-up writes in copies of the design
(its ``cdt#design_copy bytes=`` marks: a padding to whole blocks, a
blockify, the weighted ``X·w``), in GiB a traced problem; None where the
traces hold none of the port's ranges."""

from .. import program_spans


def read(rec):
    tps = [tp for tp, _ in rec["traced"]]
    if not tps or not program_spans.instrumented(tps):
        return None
    return sum(m["bytes"] for tp in tps
               for m in program_spans.marks(tp, "design_copy")) \
        / 2**30 / len(tps)
