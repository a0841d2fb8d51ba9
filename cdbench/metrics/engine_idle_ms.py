"""The device's idle time, in ms a traced problem, owned by the port's
engine spans (``cd.*``: the blocked problem's build, the solve, λmax,
and an epoch's full check, compaction round or active pass; ``group.*``:
the group engine's build, solve, λmax and passes with their eager block
visits): each idle piece goes to the innermost span that holds it
(``program_spans.py``)."""

from .. import program_spans


def read(rec):
    return program_spans.idle_ms(
        rec, lambda name: name.startswith(("cd.", "group.")))
