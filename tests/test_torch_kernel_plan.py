"""The launch planners of the port's hand-written kernels, on the CPU.

``kernels/active_pass.py::plan_active_pass`` picks K1's route (one
thread-block cluster of at most 16 CTAs, or a cooperative grid) and sizes
its grid and shared memory; ``kernels/gradient_sweep.py::plan_dense_sweep``
lays out K5's items, decides when it splits the rows and when a tile's
slices are one cluster;
``kernels/check.py::plan_check`` sizes K3/K4's cooperative grid and
picks their route (one plain CTA at nb <= 8);
``kernels/blockify.py::plan_rows`` cuts the set-up copy's rows into
chunks.  All are
pure Python, so they are held here against hand-worked cases for an H100
(132 SMs, 232,448 bytes of shared memory a CTA may opt in to).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from coordinatedescent_jl_tpu_torch.kernels import (  # noqa: E402
    active_pass, blockify, check, gradient_sweep)

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
    designs' block in shared memory, on the cluster route: 94,864 bytes of
    header, sums, Gram, vectors and slots, 1,056 of the partial c's (two
    parities) and ‖r‖² the cluster reads and the Gram copies' mbarrier,
    plus 32 rows of r and 32 × 128 of X_b (16,512).  K5 (f32, re-split): one column tile over 16 slices of
    32 rows (the last 20), one cluster; the f64 forms keep the 3 slices of
    167 rows that 4 CTAs an SM and 128 rows a slice give, also as one
    cluster.  K3/K4: one CTA, the row kept in registers, whatever the
    residency."""
    k1 = active_pass.plan_active_pass(500, 128, 4, SMS, OPTIN)
    assert k1 == active_pass.ActivePlan(16, 32, True, True, 112_432, True)
    assert k1.grid * k1.rows - 500 == 12
    k5 = gradient_sweep.plan_dense_sweep(1, 500, 128, SMS, resplit=True)
    assert k5 == gradient_sweep.SweepPlan(1, 16, 32, 16, True)
    k5 = gradient_sweep.plan_dense_sweep(1, 500, 128, SMS)
    assert k5 == gradient_sweep.SweepPlan(1, 3, 167, 3, True)
    for resident in (2, 3, 4):
        assert check.plan_check(1, 128, SMS, resident) == check.CheckPlan(
            1, 1, True)


@pytest.mark.parametrize("itemsize, gram, most", [
    (4, True, 1024), (4, False, 1024), (8, True, 1008), (8, False, 880)])
def test_active_pass_cluster_route_bounds(itemsize, gram, most):
    """K1 at B = 128 takes the cluster route up to the largest n whose 16
    CTAs of at most 64 rows keep every row of r and X_b in shared memory,
    and the cooperative route from one row past it.  f32: 64 rows (16 x
    64 = 1,024; shared memory would hold 264 rows with a Gram, 256
    without, but 16 CTAs of 125 and 256 rows measured slower than the
    cooperative route).  f64 with a Gram: 165,136 bytes of the cooperative
    layout, 2,080 of the partials the cluster reads and its mbarrier, and
    1,032 a row leave 63 rows a CTA; without a Gram each CTA also holds
    its 1,024-entry slice of the summed Gram (55 rows)."""
    plan = active_pass.plan_active_pass(most, 128, itemsize, SMS, OPTIN,
                                        gram)
    assert plan.cluster and plan.grid == 16 and plan.rows == most // 16
    assert plan.keep_x and plan.keep_r and plan.smem <= OPTIN
    past = active_pass.plan_active_pass(most + 1, 128, itemsize, SMS, OPTIN,
                                        gram)
    assert not past.cluster and past.grid > 16
    # the other route at the same CTAs and rows differs only in the
    # cluster's partials
    coop = active_pass.on_route(plan, False, 128, itemsize, gram)
    assert (coop.grid, coop.rows, coop.cluster) == (16, most // 16, False)
    extra = 2 * 128 + 2 * (16 // itemsize)
    if not gram:
        extra += 128 * 128 // 16
    assert plan.smem - coop.smem == itemsize * extra


def test_active_pass_cluster_route_hand_worked():
    """f32, B = 128, a Gram: n = 500 gives 16 CTAs of 32 rows; n = 100 4
    CTAs of 25; n = 1,000 16 CTAs of 63 (the cooperative route would
    take 32 of 32); the bench's n = 10,000 stays cooperative, as before."""
    plan = active_pass.plan_active_pass
    assert plan(500, 128, 4, SMS, OPTIN)[:2] == (16, 32)
    assert plan(100, 128, 4, SMS, OPTIN) == active_pass.ActivePlan(
        4, 25, True, True, 94_864 + 4 * (264 + 25 * 129), True)
    big = plan(1000, 128, 4, SMS, OPTIN)
    assert (big.grid, big.rows, big.cluster) == (16, 63, True)
    assert not plan(10_000, 128, 4, SMS, OPTIN).cluster


@pytest.mark.parametrize("nb, n, W, resplit, want", [
    # the varying-coefficient block, f32: 16 slices of 32 rows, one cluster
    (1, 500, 128, True, (16, 32, 16, True)),
    # the same block in the f64 forms: today's 3 slices, now one cluster
    (1, 500, 128, False, (3, 167, 3, True)),
    # grad_f64 on a narrow dense design: 7 slices of 143 rows, unchanged
    (1, 1000, 100, False, (7, 143, 7, True)),
    # grad_f64 at n = 10K: 78 slices, more than a cluster: two launches
    (1, 10_000, 100, False, (78, 129, 78, False)),
    # the working set at n = 10K: 66 slices and two launches either way
    (8, 10_000, 128, True, (66, 152, 528, False)),
    (8, 10_000, 128, False, (66, 152, 528, False)),
    # 2,048 rows is the largest f32 re-split; one more keeps 128-row slices
    (1, 2048, 128, True, (16, 128, 16, True)),
    (1, 2049, 128, True, (16, 129, 16, True)),
    (1, 4000, 128, True, (31, 130, 31, False)),
    # the bench's 782 tiles: one slice, the persistent grid
    (782, 10_000, 128, True, (1, 10_000, 782, False)),
])
def test_dense_sweep_cluster_plan(nb, n, W, resplit, want):
    plan = gradient_sweep.plan_dense_sweep(nb, n, W, SMS, resplit)
    assert (plan.split, plan.rows, plan.grid, plan.cluster) == want
    assert plan.split * plan.rows >= n > (plan.split - 1) * plan.rows
    # a cluster holds at most 16 CTAs, its grid is every item
    if plan.cluster:
        assert 2 <= plan.split <= 16 and plan.grid == plan.tiles * plan.split


@pytest.mark.parametrize("B", [100, 128, 256])
@pytest.mark.parametrize("nb", [1, 2, 3, 5, 8, 9, 16, 782])
def test_check_route(nb, B):
    """K3/K4 take the plain one-CTA route wherever the plan's grid is one
    CTA (nb <= 8, whatever the residency: the varying-coefficient scan's
    one block of 128 among them), the cooperative route above; the
    cooperative route forced at one CTA is launched as such."""
    for resident in (2, 3, 4):
        plan = check.plan_check(nb, B, SMS, resident)
        assert plan.cta == (plan.grid == 1) == (nb <= 8)
        assert not plan._replace(coop=True).cta
        assert plan._replace(coop=True).grid == plan.grid


def test_cluster_plans_on_a_card_of_8_cta_clusters():
    """A card whose largest cluster is 8 CTAs (``max_cluster``, from its
    occupancy query) gets plans of at most 8: K1 at the
    varying-coefficient point takes 8 CTAs of 63 rows, n = 1,024 (128 rows
    a CTA, over the 64-row cap) the cooperative route; K5's f32 block of
    500 rows 8 slices of 63, at 2,048 rows 8 of 256, one cluster each;
    ``grad_f64`` at (1,000, 100) keeps its 7 slices, at 12 slices (n =
    1,600) the two-kernel route.  At 16 the plans are the H100's."""
    k1 = active_pass.plan_active_pass(500, 128, 4, SMS, OPTIN, True, 8)
    assert (k1.grid, k1.rows, k1.cluster) == (8, 63, True)
    assert k1.smem == active_pass._smem(128, 4, 8, 63, True, True, True,
                                        True)
    assert not active_pass.plan_active_pass(1024, 128, 4, SMS, OPTIN, True,
                                            8).cluster
    for n, gram in ((500, True), (1024, True), (1008, True), (880, False)):
        for itemsize in (4, 8):
            assert active_pass.plan_active_pass(
                n, 128, itemsize, SMS, OPTIN, gram,
                16) == active_pass.plan_active_pass(n, 128, itemsize, SMS,
                                                    OPTIN, gram)
    sweep = gradient_sweep.plan_dense_sweep
    assert sweep(1, 500, 128, SMS, True, 8) == gradient_sweep.SweepPlan(
        1, 8, 63, 8, True)
    assert sweep(1, 2048, 128, SMS, True, 8) == gradient_sweep.SweepPlan(
        1, 8, 256, 8, True)
    assert sweep(1, 1000, 100, SMS, False, 8) == sweep(1, 1000, 100, SMS)
    wide = sweep(1, 1600, 100, SMS, False, 8)
    assert (wide.split, wide.cluster) == (12, False)
    assert sweep(1, 1600, 100, SMS).cluster
    for args in ((1, 500, 128, SMS, True), (1, 500, 128, SMS, False),
                 (8, 10_000, 128, SMS, True)):
        assert sweep(*args, 16) == sweep(*args)


@pytest.mark.parametrize("nb, n, lanes, R, chunks", [
    (782, 10_000, 32, 228, 44),     # 10K x 100K f32: 98 CTAs of 8 blocks
    (782, 10_000, 64, 455, 22),     # the same in f64: 196 CTAs of 4
    (7813, 1_000, 32, 200, 5),      # 1,000 x 1M f32: 977 CTAs of 8
    (1, 500, 32, 72, 7),            # one block: chunks of 64 rows or more
    (6, 1_000, 128, 67, 15),        # scalar f32 (p % 4 != 0): 2 blocks a CTA
    (2, 40, 32, 40, 1),             # under 2 x 64 rows: one chunk
])
def test_blockify_row_chunks(nb, n, lanes, R, chunks):
    """The set-up copy's row chunks on the H100 (132 SMs): enough chunks
    for 4 waves of 8 CTAs an SM, a CTA copying 256 / lanes adjacent
    blocks, at least 64 rows a chunk; every row in one chunk and no chunk
    empty."""
    got = blockify.plan_rows(nb, n, lanes, SMS)
    assert (got, -(-n // got)) == (R, chunks)
    assert (chunks - 1) * got < n <= chunks * got
