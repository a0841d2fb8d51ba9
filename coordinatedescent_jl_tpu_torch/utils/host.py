"""Device→host reads of the solver's control flow, counted.

The JAX package keeps its epoch loop, passes and checks on the device
(``lax.while_loop`` / ``lax.cond``).  The port runs them as Python control
flow, and every branch on a device value is a device sync.  All of them go
through :func:`item` / :func:`tolist`, so a run can report how many syncs
each epoch costs (``COUNTS["host_reads"] / COUNTS["epochs"]``).
"""

from __future__ import annotations

COUNTS = {"host_reads": 0, "epochs": 0}


def reset():
    for k in COUNTS:
        COUNTS[k] = 0


def item(t):
    """``t.item()``, counted as one host read."""
    COUNTS["host_reads"] += 1
    return t.item()


def tolist(t):
    """``t.tolist()``, counted as one host read."""
    COUNTS["host_reads"] += 1
    return t.tolist()


def numpy(t):
    """``t`` as a numpy array on the host, counted as one host read."""
    COUNTS["host_reads"] += 1
    return t.detach().cpu().numpy()
