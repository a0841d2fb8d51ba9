"""The device's idle time, in ms a traced problem, owned by the port's
batched certify/refine spans: a chunk of lanes (``path.refine``,
``vc.refine``), its rounds (``path.refine_round``, ``vc.refine_round``)
and the path's block FISTA (``path.union_block_fista``); each idle piece
goes to the innermost span that holds it (``program_spans.py``)."""

from .. import program_spans

_REFINE = {"path.refine", "path.refine_round", "path.union_block_fista",
           "vc.refine", "vc.refine_round"}


def read(rec):
    return program_spans.idle_ms(rec, _REFINE.__contains__)
