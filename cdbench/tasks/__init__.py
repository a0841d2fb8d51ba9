"""The code that drives the port for each kind of problem a traffic mix
names (``"task"``).  A task module has:

- ``prepare(cfg, traffic, seed, dev)``: the inputs of every problem of a
  run, made on ``dev`` from the seed; the returned state has ``pool``, the
  number of problems the window draws from, and one more problem (index
  ``pool``) for the warm-up;
- ``solve(state, k, span)``: problem ``k`` through the port's entry
  points, each call inside ``span(<entry point>)``; returns an
  :class:`Outcome`.

The reference module of the same name (``cdbench/reference/<task>.py``)
judges the outputs.
"""

from __future__ import annotations

from typing import NamedTuple


class Outcome(NamedTuple):
    certified: bool     # by the program's own certificate
    output: object      # what the reference judges
    counts: dict        # counts the entry point reported (stats)
    # the program gives this answer no certificate of its own: the
    # reference judges it, whether or not the seed's sample drew it
    uncertified_path: bool = False
