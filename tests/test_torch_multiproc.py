"""The port's strong-scaling measurement (``coordinatedescent_jl_tpu_torch/
multiproc_bench.py``) on the CPU at a tiny shape: worlds of 1 and 2 Gloo
ranks, each pinned to one core, give the same solution within 1e-9
(float64, ``opt_tol=1e-12``), a positive efficiency, and the 2-rank
world's collectives carry bytes.  Without ``device="cpu"`` / ``--cpu`` it
runs on the cards, and raises without them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from coordinatedescent_jl_tpu_torch import bench, multiproc_bench  # noqa: E402


def test_worlds_of_one_and_two():
    out = multiproc_bench.run(n=60, p=256, s=5, worlds=(1, 2), reps=1,
                              dtype=torch.float64, opt_tol=1e-12,
                              timeout=120, device="cpu")
    assert set(out["curve"]) == {"1", "2"}
    assert out["curve"]["2"]["max_abs_diff_vs_1"] <= 1e-9
    assert out["nnz_agree"] and out["curve"]["1"]["nnz"] > 0
    assert isinstance(out["efficiency"], float) and out["efficiency"] > 0
    assert out["efficiency"] == out["curve"]["2"]["efficiency"]
    assert np.isclose(out["speedup"],
                      out["t_1proc_s"] / out["t_2proc_s"], rtol=1e-2)
    coll = out["curve"]["2"]["collectives"]
    assert coll["all_reduce"]["calls"] > 0 and coll["all_reduce"]["bytes"] > 0
    assert out["cores_per_worker"] == 1 and out["device"] == "cpu"


def test_the_first_world_is_the_world_of_one():
    with pytest.raises(ValueError):
        multiproc_bench.run(worlds=(2, 4), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_the_card_is_the_default():
    with pytest.raises(RuntimeError, match="CUDA devices"):
        multiproc_bench.run(n=60, p=256, s=5, worlds=(1,), reps=1)
    with pytest.raises(SystemExit, match="--cpu"):
        multiproc_bench.main([])
    assert multiproc_bench.card_worlds() == ()


def test_the_bench_asks_for_the_cpu_and_says_so(monkeypatch):
    asked = {}

    def run(**kw):
        asked.update(kw)
        return {"efficiency": 0.5, "cores": 8, "t_1proc_s": 1.0,
                "t_2proc_s": 1.0, "t_4proc_s": 1.0}

    monkeypatch.setattr(multiproc_bench, "run", run)
    extra = {}
    bench.multiproc_section(extra)
    assert asked == {"device": "cpu"}
    assert extra["multiproc_efficiency"] == 0.5
    assert "not a number of the card" in extra["multiproc_measured_on"]
    assert "multiproc_measured_on" not in bench.COMPACT_KEYS
