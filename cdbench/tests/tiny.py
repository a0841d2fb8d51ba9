"""Each cell cut to a size the CPU runs in seconds, for the tests: the same
configuration and traffic files with the design's scale, the pool, the
grid and the sample shrunk (every width and option as in the files)."""

from __future__ import annotations

import time

from cdbench import run

_SMALL = {"lasso_gauss_10kx100k": {"n": 400, "p": 1024},
          "vc_locpoly_n500p50": {"n": 60, "p": 4,
                                 "grid": {"lo": 0.05, "hi": 0.95,
                                          "points": 24}}}


def tiny(name: str):
    """``(cell, cfg, traffic)`` of the cell ``name``, cut for the CPU."""
    cell, cfg, traffic = run.resolve(run.load_spec(), name)
    cfg = {**cfg, **_SMALL[cell["config"]]}
    traffic = {**traffic, "pool": 4,
               "check": {**traffic["check"], "span": 2, "problems": 1}}
    if "planted" in traffic:
        traffic["planted"] = 6
    if "n_act" in traffic:
        traffic["n_act"] = 3
    return cell, cfg, traffic


def tiny_run(name: str, seed: int = 20_261_017_123, seconds: float = 0.0):
    """One run of the cut cell on the CPU (one problem at ``seconds=0``);
    the run's record."""
    import torch

    cell, cfg, traffic = tiny(name)
    torch.set_num_threads(1)                  # as run.main sets it
    return run.run_cell(cell, cfg, traffic, seed, seconds, False,
                        torch.device("cpu"), time.perf_counter())
