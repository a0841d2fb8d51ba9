"""How full the batched refine's union working set would have to be, in
%: Σ over the port's ``cdt#union cap=`` marks (one a refine round of
``lasso_path``'s batched execution) of the columns with positive union
priority (a support column of an uncertified lane, or a violation above
the noise floor; counted after the entry point returns, ``cdt#counted``)
÷ Σ the union's capacity ``compact_size``, over the traced problems.
Above 100 the rounds select from more columns than the union holds.
None where no traced problem holds a mark (no refine round, or a tree
that opens none), or where marks and counts differ in number."""

from .. import counted


def read(rec):
    need = cap = 0
    for tp, _ in rec["traced"]:
        ms = counted.marks(tp, "union")
        if ms is None:
            return None
        need += sum(m["count"] for m in ms)
        cap += sum(m["cap"] for m in ms)
    if not cap:
        return None
    return 100.0 * need / cap
