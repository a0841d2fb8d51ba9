"""The device's idle time, in ms a traced problem, owned by the port's
float64 polish spans (``polish.*``: the polish's loop with its NumPy
working-set bookkeeping, the restricted solve, the certificate); each
idle piece goes to the innermost span that holds it
(``program_spans.py``)."""

from .. import program_spans


def read(rec):
    return program_spans.idle_ms(rec,
                                 lambda name: name.startswith("polish."))
