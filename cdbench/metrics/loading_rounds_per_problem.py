"""The feasible Lasso's loading rounds, per traced problem: the port's
``feasible.round`` spans (a float32 round: a warm weighted solve and a
loadings sweep) and ``polish.loading_round`` spans (a float64 round: a
certified ``polish_lasso`` and a float64 loadings sweep).  None where the
traces hold no such span (a tree that opens none)."""

from .. import program_spans

SPANS = ("feasible.round", "polish.loading_round")


def read(rec):
    tps = [tp for tp, _ in rec["traced"]]
    rounds = sum(1 for tp in tps for name, _, _ in program_spans.spans(tp)
                 if name in SPANS)
    if not rounds:
        return None
    return rounds / len(tps)
