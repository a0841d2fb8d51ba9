"""The batched certify/refine rounds the entry point reported
(``stats["refine_rounds"]``), per window problem."""


def read(rec):
    ps = rec["problems"]
    if not ps or any("refine_rounds" not in p.counts for p in ps):
        return None
    return sum(p.counts["refine_rounds"] for p in ps) / len(ps)
