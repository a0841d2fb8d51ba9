"""PyTorch port: the group engine's active-pass routing and the group pass
kernel's wrapper (``kernels/group_pass.py``) on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py`` holds it
against ``ops/group_cd.py::_group_active_pass_plain``).  Here: its launch
plan and shared memory at hand-worked shapes, the inputs the wrapper
refuses, and the engine's choice of the plain twin for CPU tensors and for
blocks wider than 128 lanes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import coordinatedescent_jl_tpu_torch as tcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.kernels import group_pass  # noqa: E402
from coordinatedescent_jl_tpu_torch.ops import group_cd  # noqa: E402
from coordinatedescent_jl_tpu_torch.ops.prox import fista_momentum  # noqa: E402


def _case(G, p, n=60, dtype=torch.float64, seed=0):
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.standard_normal((n, p)), dtype=dtype)
    y = X[:, :G] @ torch.ones(G, dtype=dtype) + torch.as_tensor(
        rng.standard_normal(n), dtype=dtype)
    ng = -(-p // G)
    prob = group_cd._build_group_problem(X, y, torch.ones(ng, dtype=dtype),
                                         G)
    nb, B = prob.valid.shape
    beta = torch.zeros((nb, B), dtype=dtype)
    beta[0, :G] = 0.5
    st = group_cd._group_init(prob, beta, torch.Generator().manual_seed(1))
    return X, y, prob, st


@pytest.mark.parametrize("n, itemsize, plan", [
    # the group_lasso_g8 cell: 132 CTAs of 76 rows keep r and X_b
    (10_000, 4, (132, 76, True, True,
                 16 + 4 * (512 * 4 + 8 * 128 + 32 + 16 + 76 + 76 * 128))),
    (10_000, 8, (132, 76, True, True,
                 16 + 8 * (512 * 2 + 8 * 128 + 32 + 16 + 76 + 76 * 128))),
    # 1,516 rows of X_b (776 KB) do not fit: r only
    (200_000, 4, (132, 1516, False, True,
                  16 + 4 * (512 * 4 + 8 * 128 + 32 + 16 + 1516))),
    # a small n takes CTAs of 32 rows or more
    (100, 4, (4, 25, True, True,
              16 + 4 * (512 * 4 + 8 * 128 + 32 + 16 + 28 + 25 * 128))),
])
def test_group_pass_plan(n, itemsize, plan):
    """The planner at H100 shapes (132 SMs, 232,448 bytes a CTA), B = 128,
    16 steps: CTAs, rows, kept rows and shared memory, the bytes of
    ``csrc/group_pass.cu::gp_layout``."""
    got = group_pass.plan_group_pass(n, 128, itemsize, 16, 132)
    assert tuple(got) == plan
    assert got.smem == group_pass.smem_bytes(128, got.rows, got.keep_x,
                                             got.keep_r, 16, itemsize)


@pytest.mark.parametrize("case", ["dtype", "design", "wide", "device"])
def test_group_pass_wrapper_refuses_other_inputs(case):
    """``require_inputs`` raises on a dtype other than float32/float64, a
    design that is not contiguous, a block wider than 128 lanes, and
    tensors off the card (the engine runs the plain twin there)."""
    G = 130 if case == "wide" else 8
    _, _, prob, st = _case(G, 300)
    beta, order = st.beta, torch.arange(prob.valid.shape[0])
    if case == "dtype":
        beta = beta.to(torch.float16)
    if case == "design":
        prob = prob._replace(
            Xb=prob.Xb.transpose(1, 2).contiguous().transpose(1, 2))
    msg = {"dtype": "dtype torch.float16", "design": "Xb must be contiguous",
           "wide": "block width 130", "device": "not on a CUDA device"}[case]
    with pytest.raises(ValueError, match=msg):
        group_pass.require_inputs(prob, beta, st.r, st.active, order)


def test_group_engine_runs_the_plain_twin_off_the_card(monkeypatch):
    """CPU tensors take the plain twin whatever the kernels flag says of
    a wider block (B = 130: ``kernels=True`` too), bit for bit
    ``_group_active_pass_plain``; ``group_lasso`` on the CPU never reaches
    the kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("the group pass kernel was called")

    monkeypatch.setattr(group_pass, "fused_group_pass", refuse)
    _, _, prob, st = _case(130, 300)
    coefs = fista_momentum(16, torch.float64)
    state = st.key.get_state()
    a, ma = group_cd._group_active_pass(prob, st, 0.05, 60.0, True, coefs,
                                        True)
    st.key.set_state(state)
    b, mb = group_cd._group_active_pass_plain(prob, st, 0.05, 60.0, True,
                                              coefs)
    assert torch.equal(a.beta, b.beta) and torch.equal(a.r, b.r)
    assert torch.equal(ma, mb) and torch.equal(a.active, b.active)
    X, y, _, _ = _case(8, 300)
    sol = tcd.group_lasso(X, y, 0.05, 8, device="cpu")
    assert bool(torch.any(sol.x != 0))
