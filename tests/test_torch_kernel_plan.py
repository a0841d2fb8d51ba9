"""The launch planners of the port's hand-written kernels, on the CPU.

``kernels/active_pass.py::plan_active_pass`` sizes K1's cooperative grid
and its shared memory; ``kernels/gradient_sweep.py::plan_dense_sweep``
lays out K5's persistent grid and decides when it splits the rows;
``kernels/check.py::plan_check`` sizes K3/K4's cooperative grid.  All are
pure Python, so they are held here against hand-worked cases for an H100
(132 SMs, 232,448 bytes of shared memory a CTA may opt in to).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from coordinatedescent_jl_tpu_torch.kernels import (  # noqa: E402
    active_pass, check, gradient_sweep)

SMS = 132
OPTIN = 232_448


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("B", [48, 128])
@pytest.mark.parametrize("n", [100, 10_000, 50_000, 1_000_000])
def test_active_pass_plan_fits_shared_memory(n, B, itemsize):
    plan = active_pass.plan_active_pass(n, B, itemsize, SMS, OPTIN)
    assert plan.smem <= OPTIN
    assert 1 <= plan.grid <= SMS
    # every row has exactly one owner, and no CTA is left without rows
    assert plan.grid * plan.rows >= n > (plan.grid - 1) * plan.rows
    assert plan.keep_r or not plan.keep_x


def test_active_pass_plan_hand_worked():
    # f32, n = 10K, B = 128: 132 CTAs of 76 rows; the header, 512 threads'
    # 16-byte sums, the Gram at row stride 160, 9 vectors and 32 slots
    # (94,864 bytes), then 76 rows of r and 76 rows of X_b (39,216 bytes)
    plan = active_pass.plan_active_pass(10_000, 128, 4, SMS, OPTIN)
    assert plan == active_pass.ActivePlan(132, 76, True, True, 134_080)
    # f64: the Gram at row stride 144 (165,136 bytes) leaves no room for
    # the 76 rows of X_b (77,824 bytes)
    f64 = active_pass.plan_active_pass(10_000, 128, 8, SMS, OPTIN)
    assert (f64.keep_x, f64.keep_r, f64.smem) == (False, True, 165_744)
    # a small n takes fewer CTAs, 32 rows or more each
    assert active_pass.plan_active_pass(100, 128, 4, SMS, OPTIN).grid == 4
    # at n = 50K a CTA's 379 rows of X_b (194 KB) no longer fit: the
    # kernel keeps r only and reads the rows again in the residual update
    big = active_pass.plan_active_pass(50_000, 128, 4, SMS, OPTIN)
    assert (big.rows, big.keep_x, big.keep_r) == (379, False, True)
    assert big.smem == 94_864 + 4 * 379
    # a budget below the Gram's own bytes is refused, not launched
    with pytest.raises(ValueError):
        active_pass.plan_active_pass(10_000, 128, 8, SMS, 100_000)


@pytest.mark.parametrize("nb, n, W, split", [
    (782, 10_000, 128, 1),     # the bench's blocked design: no partials
    (1, 10_000, 100_000, 1),   # grad_f64 on the dense design: 782 tiles
    (8, 10_000, 128, 66),      # the working set: 8 tiles, rows split
    (8, 200, 128, 1),          # too few rows to split
])
def test_dense_sweep_plan(nb, n, W, split):
    plan = gradient_sweep.plan_dense_sweep(nb, n, W, SMS)
    assert plan.tiles == nb * -(-W // 128)
    assert plan.split == split
    assert plan.split * plan.rows >= n > (plan.split - 1) * plan.rows
    assert plan.grid == min(plan.tiles * plan.split, 8 * SMS)
    if split > 1:
        # the items give at least 4 CTAs per SM, no slice under 128 rows
        assert plan.tiles * plan.split >= 4 * SMS
        assert plan.rows >= 128


@pytest.mark.parametrize("nb, B, resident, grid, rows, keep", [
    # the bench: 782 rows of 128 on 98 CTAs of 8 warps, a row a warp, kept
    # in registers between phase A's two passes
    (782, 128, 4, 98, 1, True),
    (1, 128, 4, 1, 1, True),
    # p = 1M: 977 CTAs wanted; 4 per SM cap the grid at 528, so a warp
    # owns up to 2 rows and reads them again; 8 per SM hold all 977
    (7813, 128, 4, 528, 2, False),
    (7813, 128, 8, 977, 1, True),
    (782, 48, 4, 98, 1, True),
    (782, 200, 4, 98, 1, False),      # two chunks a row: not kept
    (30_000, 128, 8, 1056, 4, False),
])
def test_check_plan(nb, B, resident, grid, rows, keep):
    plan = check.plan_check(nb, B, SMS, resident)
    assert plan == check.CheckPlan(grid, rows, keep)
    assert 1 <= plan.grid <= SMS * resident
    # the kernel's loop: warp w of the grid owns rows w, w + 8 G, ...
    warps = 8 * plan.grid
    owned = [list(range(w, nb, warps)) for w in range(warps)]
    assert sorted(b for rs in owned for b in rs) == list(range(nb))
    assert max(len(rs) for rs in owned) == plan.rows
    # no CTA is left without rows
    assert all(owned[8 * g] for g in range(plan.grid))


def test_plans_at_the_varying_coefficient_shape():
    """The varying-coefficient scan's one-block problem (bench.py's grid:
    n = 500, p = 50 at degree 1, so 100 expanded columns padded to one
    block of B = 128, float32).  K1: 500 rows at 32 or more a CTA give 16
    CTAs of 32 rows (the last 20), each keeping its rows of r and of both
    designs' block in shared memory: 94,864 bytes of header, sums, Gram,
    vectors and slots, plus 32 rows of r and 32 × 128 of X_b (16,512).
    K5: one column tile, split over 3 slices of 167 rows (fewer than
    4 CTAs an SM would need slices under 128 rows).  K3/K4: one CTA, the
    row kept in registers, whatever the residency."""
    k1 = active_pass.plan_active_pass(500, 128, 4, SMS, OPTIN)
    assert k1 == active_pass.ActivePlan(16, 32, True, True, 111_376)
    assert k1.grid * k1.rows - 500 == 12
    k5 = gradient_sweep.plan_dense_sweep(1, 500, 128, SMS)
    assert k5 == gradient_sweep.SweepPlan(1, 3, 167, 3)
    for resident in (2, 3, 4):
        assert check.plan_check(1, 128, SMS, resident) == check.CheckPlan(
            1, 1, True)
