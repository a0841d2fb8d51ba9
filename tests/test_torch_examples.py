"""The port's demos (``coordinatedescent_jl_tpu_torch/examples``) on the
CPU: each runs with ``--cpu --small`` and prints its results; without
``--cpu`` each needs the card and raises here."""

import importlib

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

PKG = "coordinatedescent_jl_tpu_torch.examples"
EXPECT = {
    "atoms_demo": ["group lasso on cpu: ", "recovered 10)",
                   "coordinate_descent(ProxL1Group): max|Δ| vs group_lasso = "
                   "0.00e+00",
                   "symmetric thresholding: symmetric=True"],
    "lasso_path_demo": ["path on cpu: 20 points", "refits: ",
                        "batched path: shape (20, 256)", "trace: converged"],
    "production_recipes": ["path on cpu: 16 points", "converged=True",
                           "the same path as without it: True",
                           "resume: 16 points, the first 8 from the "
                           "checkpoint"],
    "multichip_demo": ["mesh: (2,) over 2 rank(s), the CPU",
                       "sharded lasso: nnz=", "2-D (batch × feature) λ grid",
                       "sharded resumable path: (10, 128)",
                       "tile-sharded lasso on (2, 1): nnz="],
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_example_runs_on_the_cpu(name, capfd):
    """``--cpu --small``: the demo runs to its end (the multichip demo in
    two spawned Gloo ranks, whose output is captured at the descriptor)."""
    importlib.import_module(f"{PKG}.{name}").main(["--cpu", "--small"])
    out = capfd.readouterr().out
    for text in EXPECT[name]:
        assert text in out, (text, out)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_example_needs_the_card_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, SystemExit)):
        importlib.import_module(f"{PKG}.{name}").main(["--small"])
