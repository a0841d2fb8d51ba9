"""The port's bench, its varying-coefficient section (bench.py:479-611) on
the CPU: at a cut shape (n = 30, p = 2, three grid points, one LOO-CV
bandwidth; float64, the plain path) it gives bench.py's keys, the batched
grid and the batched LOO-CV certified."""

import pytest

torch = pytest.importorskip("torch")

from coordinatedescent_jl_tpu_torch import bench  # noqa: E402
from coordinatedescent_jl_tpu_torch.profile_paths import (  # noqa: E402
    vc_bench_problem)

torch.set_num_threads(1)


def test_vc_section_gives_its_keys():
    vp = vc_bench_problem(torch.device("cpu"), n=30, p=2, g=3)
    vp = vp._replace(X=vp.X.double(), z=vp.z.double(), y=vp.y.double(),
                     h_arr=(0.2,))
    extra = {}
    bench.vc_section(extra, bench.Clock(torch.device("cpu"), False), vp)
    assert not [k for k in extra if k.endswith("_error")]
    assert extra["locpolyl1_batched_certified"] is True
    assert extra["lvocv_locpolyl1_batched_certified"] is True
    for key in ("locpolyl1_scan_s", "locpolyl1_batched_s", "locpolyl1_s",
                "locpoly_s", "lvocv_locpolyl1_seq_s",
                "lvocv_locpolyl1_batched_s", "lvocv_locpolyl1_s"):
        assert extra[key] >= 0, key
    assert extra["locpolyl1_s"] <= extra["locpolyl1_scan_s"]
    assert extra["locpolyl1_batched_vs_scan_max_abs_diff"] < 1e-4
    assert extra["lvocv_batched_vs_seq_max_rel_diff"] < 5e-2
