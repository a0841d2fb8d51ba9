"""On the card: the control (the plain reference in the lower precision
each traffic mix names, put in the program's place) fails the cell's
limit, and the program passes it, at a size a test run holds (the
10K x 100K design cut to 4,000 x 40,000; the varying-coefficient cell at
its own size).  ``python -m pytest cdbench/tests -q -m cuda``."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from cdbench import control, run

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
_CUT = {"lasso_gauss_10kx100k": {"n": 4000, "p": 40_000}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the port's kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limit_and_the_program_passes(dev, cell):
    c, cfg, traffic = run.resolve(run.load_spec(), cell)
    cfg = {**cfg, **_CUT.get(c["config"], {})}
    traffic = {**traffic, "pool": min(traffic["pool"], 64)}
    rec = control.readings(c, cfg, traffic, 2_026_101_716, 1, dev)
    for name, limit in traffic["limits"].items():
        assert all(v[name] <= limit for v in rec["program"].values()), rec
        assert all(v[name] > limit for v in rec["control"].values()), rec
