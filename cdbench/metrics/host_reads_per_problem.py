"""The port's counted device-to-host reads (``utils/host.py``'s
``COUNTS["host_reads"]``) over the window, per window problem."""


def read(rec):
    n = len(rec["problems"])
    return rec["host_reads"] / n if n else None
