"""Hand-written CUDA kernels of the PyTorch port against their plain twins.

These need an NVIDIA GPU with ``nvcc`` (Hopper, ``sm_90a``) and skip
elsewhere.  Run them on the card with

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU machine
does not need).  Shapes are small, with a ragged row tail, so every kernel
path runs: both inners, Gram on and off, float32 and float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from coordinatedescent_jl_tpu_torch import (  # noqa: E402
    CDOptions, lasso, lasso_duality_gap_compensated, lasso_path,
    polish_lasso)
from coordinatedescent_jl_tpu_torch.kernels import (  # noqa: E402
    active_pass, check, gradient_sweep, union_fista, vc_round)
from coordinatedescent_jl_tpu_torch.ops import (  # noqa: E402
    batched_certify, block_cd)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(dev, dtype, n=1000, p=700, B=128, gram=False, seed=0):
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.standard_normal((n, p)), dtype=dtype, device=dev)
    beta = np.zeros(p)
    beta[rng.choice(p, 30, replace=False)] = rng.standard_normal(30)
    y = X @ torch.as_tensor(beta, dtype=dtype, device=dev)
    y = y + 0.3 * torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                                  device=dev)
    opts = CDOptions(block_size=B, cache_gram=gram, compact=False)
    lamw = torch.as_tensor(0.5 + rng.random(p), dtype=dtype, device=dev)
    prob = block_cd.build_blocked("ls", opts, lamw, X=X, y=y)
    nb = prob.lamw.shape[0]
    b0 = torch.as_tensor(rng.standard_normal((nb, B))
                         * (rng.random((nb, B)) < 0.2), dtype=dtype,
                         device=dev) * prob.valid
    b0[1] = 0.0
    st = block_cd._init_state("ls", prob, b0.contiguous(), None)
    return prob, st


# f32: the kernels add in another order than the twins' library products
TOL = {torch.float32: 2e-4, torch.float64: 1e-11}


def _k1_plan(dev, n, B, dtype):
    return active_pass.plan_active_pass(
        n, B, torch.empty((), dtype=dtype).element_size(),
        torch.cuda.get_device_properties(dev).multi_processor_count,
        torch.cuda.get_device_properties(dev).shared_memory_per_block_optin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gram", [False, True])
@pytest.mark.parametrize("inner", ["ista", "exact"])
@pytest.mark.parametrize("B", [128, 48])
@pytest.mark.parametrize("n", [1000, 50_000])
def test_active_pass_kernel_matches_twin(dev, dtype, gram, inner, B, n):
    """K1 against its twin: n = 1000 leaves the last CTA a ragged 8 rows
    and keeps the row tile in shared memory; at n = 50,000 the planner
    keeps r only (B = 128), so the residual update reads X_b again.  One
    launch, no host read."""
    from coordinatedescent_jl_tpu_torch.utils import host

    plan = _k1_plan(dev, n, B, dtype)
    assert plan.grid * plan.rows > n
    if n == 1000:
        assert plan.keep_x
    elif B == 128:
        assert not plan.keep_x and plan.keep_r
    prob, st = _problem(dev, dtype, n=n, B=B, gram=gram)
    nb = prob.lamw.shape[0]
    args = (prob, st.beta, st.r, st.active, 0.05, float(n),
            torch.arange(nb, device=dev), torch.arange(B, device=dev))
    count = active_pass.LAUNCHES_KIND["ls"]
    f64 = dtype == torch.float64
    n0 = count[f64]
    reads = host.COUNTS["host_reads"]
    bk, rk, mk, _ = active_pass.fused_active_pass(*args, inner=inner,
                                                  rsqr=st.rsqr)
    assert host.COUNTS["host_reads"] == reads
    torch.cuda.synchronize()
    assert count[f64] == n0 + 1
    bp, rp, mp, _ = active_pass.fused_active_pass_plain(*args, inner=inner)
    tol = TOL[dtype]
    torch.testing.assert_close(bk, bp, atol=tol, rtol=0)
    torch.testing.assert_close(rk, rp, atol=10 * tol * max(1.0, n / 1000),
                               rtol=0)
    torch.testing.assert_close(mk, mp, atol=tol, rtol=0)


def _kind_problem(dev, dtype, kind, n, B, gram, seed=0):
    """``_problem`` with the wls kind's row weights, or the sqrt kind's
    running ``‖r‖²`` in the state."""
    prob, st = _problem(dev, dtype, n=n, B=B, gram=gram, seed=seed)
    if kind == "ls":
        return prob, st
    rng = np.random.default_rng(seed + 100)
    p = int(prob.valid.sum())
    X = prob.Xb.permute(1, 0, 2).reshape(n, -1)[:, :p].contiguous()
    w = torch.as_tensor(0.5 + rng.random(n), dtype=dtype, device=dev)
    opts = CDOptions(block_size=B, cache_gram=gram, compact=False)
    prob = block_cd.build_blocked(kind, opts, prob.lamw.reshape(-1)[:p],
                                  X=X, y=prob.y, w=w)
    return prob, block_cd._init_state(kind, prob, st.beta, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gram", [False, True])
@pytest.mark.parametrize("inner", ["ista", "exact"])
@pytest.mark.parametrize("n,B", [(1000, 128), (1000, 48), (50_000, 128)])
@pytest.mark.parametrize("kind", ["wls", "sqrt"])
def test_active_pass_kernel_kinds_match_twin(dev, kind, n, B, inner, gram,
                                             dtype):
    """K1's wls and sqrt forms against the twin (β, r, maxh and rsqr), with
    the rows kept in shared memory (n = 1000) and read again for the
    update (n = 50,000), one launch and no host read, counted by kind.
    rsqr is relative: 1e-5 in f32 (a sum of n squares in another order;
    through the exact scan it also carries the cancellation of its
    three-term updates), 1e-11 in f64."""
    from coordinatedescent_jl_tpu_torch.utils import host

    prob, st = _kind_problem(dev, dtype, kind, n, B, gram)
    assert (prob.Xwb is prob.Xb) == (kind != "wls")
    nb = prob.lamw.shape[0]
    lam0 = 0.05 if kind == "wls" else 0.05 * n ** 0.5
    args = (prob, st.beta, st.r, st.active, lam0, float(n),
            torch.arange(nb, device=dev), torch.arange(B, device=dev))
    kw = dict(kind=kind, inner=inner, rsqr=torch.dot(st.r, st.r))
    f64 = dtype == torch.float64
    n0 = active_pass.LAUNCHES_KIND[kind][f64]
    reads = host.COUNTS["host_reads"]
    bk, rk, mk, sk = active_pass.fused_active_pass(*args, **kw)
    assert host.COUNTS["host_reads"] == reads
    torch.cuda.synchronize()
    assert active_pass.LAUNCHES_KIND[kind][f64] == n0 + 1
    bp, rp, mp, sp = active_pass.fused_active_pass_plain(*args, **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(bk, bp, atol=tol, rtol=0)
    torch.testing.assert_close(rk, rp, atol=10 * tol * max(1.0, n / 1000),
                               rtol=0)
    torch.testing.assert_close(mk, mp, atol=tol, rtol=0)
    torch.testing.assert_close(sk, sp, atol=0, rtol=1e-11 if f64 else 1e-5)
    if kind == "sqrt":
        assert float(mk) > 0 and float(sk) != float(kw["rsqr"])
    else:
        assert float(sk) == float(kw["rsqr"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gram", [False, True])
@pytest.mark.parametrize("inner", ["ista", "exact"])
@pytest.mark.parametrize("kind", ["ls", "wls", "sqrt"])
def test_active_pass_cluster_route_matches_cooperative_bitwise(
        dev, kind, inner, gram, dtype):
    """K1's cluster route (n = 500: 16 CTAs of 32 rows, one cluster, the
    partials read out of the CTAs' shared memory) against the cooperative
    route at the same CTAs and rows (the partials through global scratch):
    the same bits in β, r, maxh and rsqr, over six blocks (so both visit
    parities), and both near the twin."""
    n, B = 500, 128
    prob, st = _kind_problem(dev, dtype, kind, n, B, gram)
    nb = prob.lamw.shape[0]
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = active_pass.plan_active_pass(
        n, B, itemsize,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        torch.cuda.get_device_properties(dev).shared_memory_per_block_optin,
        gram)
    assert plan.cluster and (plan.grid, plan.rows) == (16, 32)
    lam0 = 0.05 * n ** 0.5 if kind == "sqrt" else 0.05
    args = (prob, st.beta, st.r, st.active, lam0, float(n),
            torch.arange(nb, device=dev), torch.arange(B, device=dev))
    kw = dict(kind=kind, inner=inner, rsqr=torch.dot(st.r, st.r))
    coop = active_pass.on_route(plan, False, B, itemsize, gram)
    outk = active_pass.fused_active_pass(*args, **kw, plan=plan)
    outc = active_pass.fused_active_pass(*args, **kw, plan=coop)
    for a, c in zip(outk, outc):
        assert torch.equal(a, c)
    assert torch.equal(outk[0], active_pass.fused_active_pass(*args, **kw)[0])
    bp, rp, mp, sp = active_pass.fused_active_pass_plain(*args, **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(outk[0], bp, atol=tol, rtol=0)
    torch.testing.assert_close(outk[1], rp, atol=10 * tol, rtol=0)
    torch.testing.assert_close(outk[2], mp, atol=tol, rtol=0)
    if kind == "sqrt":
        torch.testing.assert_close(outk[3], sp, atol=0,
                                   rtol=1e-11 if itemsize == 8 else 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_active_pass_cluster_momentum_past_the_stored_steps(dev, dtype):
    """Both routes read the FISTA momentum from the host's table
    (``ops/prox.py::fista_momentum``) at any number of steps: the same
    bits at 16, 256 and 300 steps."""
    n, B = 300, 16
    prob, st = _problem(dev, dtype, n=n, p=80, B=B, gram=True)
    nb = prob.lamw.shape[0]
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = active_pass.plan_active_pass(n, B, itemsize, 132)
    assert plan.cluster
    args = (prob, st.beta, st.r, st.active, 0.05, float(n),
            torch.arange(nb, device=dev), torch.arange(B, device=dev))
    for iters in (16, 256, 300):
        outk = active_pass.fused_active_pass(*args, inner="ista",
                                             iters=iters, plan=plan)
        outc = active_pass.fused_active_pass(
            *args, inner="ista", iters=iters,
            plan=active_pass.on_route(plan, False, B, itemsize))
        for a, c in zip(outk, outc):
            assert torch.equal(a, c), iters


def test_active_pass_cluster_route_refuses_a_larger_cluster(dev):
    """A cluster of more than 16 CTAs is refused, not run another way."""
    prob, st = _problem(dev, torch.float32, n=1000, gram=True)
    nb = prob.lamw.shape[0]
    plan = active_pass.plan_active_pass(1000, 128, 4, 132)
    wide = active_pass.on_route(plan._replace(grid=32, rows=32), True, 128, 4)
    n0 = active_pass.LAUNCHES_KIND["ls"][0]
    with pytest.raises(RuntimeError, match="active_pass failed"):
        active_pass.fused_active_pass(
            prob, st.beta, st.r, st.active, 0.05, 1000.0,
            torch.arange(nb, device=dev), torch.arange(128, device=dev),
            inner="ista", plan=wide)
    assert active_pass.LAUNCHES_KIND["ls"][0] == n0


@pytest.mark.parametrize("case", ["vc", "tiles6", "f64", "grad64", "grad64_odd"])
def test_dense_sweep_cluster_route_matches_two_kernels_bitwise(dev, case):
    """K5's cluster route (a tile's S slices one cluster, CTA 0 adding the
    partials in slice order out of shared memory) against the two-kernel
    route at the same S (the partials through HBM, the reduce kernel): the
    same bits.  The varying-coefficient block (1, 500, 128) at S = 3 and
    16, six tiles of n = 1000 rows, the f64 blocked form, and grad_f64 at
    p = 100 and 701 (scalar loads) with its unchanged slices."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(4)
    f64 = case == "f64"
    if case.startswith("grad64"):
        p = 701 if case == "grad64_odd" else 100
        X = torch.as_tensor(rng.standard_normal((1000, p)),
                            dtype=torch.float32, device=dev)
        r = torch.as_tensor(rng.standard_normal(1000), dtype=torch.float64,
                            device=dev)
        plan = gradient_sweep.plan_dense_sweep(1, 1000, p, sms)
        assert plan.cluster and 1 < plan.split <= 16
        plans = [plan]
        run = lambda pl: gradient_sweep.grad_f64(X, r, plan=pl)  # noqa: E731
    else:
        nb, n = (1, 500) if case == "vc" else (6, 1000)
        dt = torch.float64 if f64 else torch.float32
        Xwb = torch.as_tensor(rng.standard_normal((nb, n, 128)), dtype=dt,
                              device=dev)
        r = torch.as_tensor(rng.standard_normal(n), dtype=dt, device=dev)
        plan = gradient_sweep.sweep_plan(Xwb)
        assert plan.cluster
        plans = [plan]
        if case == "vc":
            assert (plan.split, plan.rows) == (16, 32)
            plans.append(gradient_sweep.SweepPlan(1, 3, 167, 3, True))
        run = lambda pl: gradient_sweep.fused_gradient_sweep(  # noqa: E731
            Xwb, r, plan=pl)
    for pl in plans:
        two = pl._replace(cluster=False, grid=pl.tiles * pl.split)
        ck, c2 = run(pl), run(two)
        assert torch.equal(ck, c2), pl
    if case == "vc":
        cp = gradient_sweep.fused_gradient_sweep_plain(Xwb, r)
        torch.testing.assert_close(ck, cp, atol=1e-5 * float(cp.abs().max()),
                                   rtol=0)


def test_active_pass_kernel_refuses_a_second_design_unless_wls(dev):
    prob, st = _kind_problem(dev, torch.float32, "wls", 1000, 128, True)
    nb = prob.lamw.shape[0]
    with pytest.raises(ValueError, match="Xwb must be Xb"):
        active_pass.fused_active_pass(
            prob, st.beta, st.r, st.active, 0.05, 1000.0,
            torch.arange(nb, device=dev), torch.arange(128, device=dev),
            kind="sqrt", inner="ista")


@pytest.mark.parametrize("kind", ["wls", "sqrt"])
def test_solve_kinds_kernels_match_plain(dev, kind):
    """A whole wls / sqrt solve (f32, working set on) with the kernels and
    with ``use_pallas=False``: the same support; the sqrt solve never
    launches K3/K4, the wls solve does."""
    from coordinatedescent_jl_tpu_torch import (ProxL1, SqrtLassoLoss,
                                                WeightedLSLoss,
                                                coordinate_descent)

    rng = np.random.default_rng(5)
    n, p = 2000, 6000
    X = torch.as_tensor(rng.standard_normal((n, p)), dtype=torch.float32,
                        device=dev)
    beta = torch.zeros(p, device=dev)
    beta[::400] = 2.0
    y = X @ beta + torch.as_tensor(rng.standard_normal(n),
                                   dtype=torch.float32, device=dev)
    w = torch.as_tensor(0.5 + rng.random(n), dtype=torch.float32, device=dev)
    loss = (WeightedLSLoss(y, X, w) if kind == "wls" else SqrtLassoLoss(y, X))
    lam = 0.2 if kind == "wls" else 0.2 * n ** 0.5
    opts = CDOptions(opt_tol=1e-6, randomize=False, max_iter=300)
    a0, b0 = check.LAUNCHES_A, check.LAUNCHES_B
    k0 = active_pass.LAUNCHES_KIND[kind][0]
    bk, _ = coordinate_descent(torch.zeros(p, device=dev), loss, ProxL1(lam),
                               opts)
    assert active_pass.LAUNCHES_KIND[kind][0] > k0
    if kind == "sqrt":
        assert (check.LAUNCHES_A, check.LAUNCHES_B) == (a0, b0)
    else:
        assert check.LAUNCHES_A > a0
    bp, _ = coordinate_descent(torch.zeros(p, device=dev), loss, ProxL1(lam),
                               opts.replace(use_pallas=False))
    differ = (bk != 0) != (bp != 0)
    assert int((differ & (torch.maximum(bk.abs(), bp.abs()) > 1e-4)).sum()) == 0
    assert int((bk != 0).sum()) >= 15
    torch.testing.assert_close(bk, bp, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_active_pass_kernel_is_one_launch(dev, dtype):
    """One device kernel per call (the engine's call, with its rsqr), and
    with no active block the outputs are the inputs."""
    from coordinatedescent_jl_tpu_torch.profile_paths import trace_one_call

    prob, st = _problem(dev, dtype, gram=True)
    nb = prob.lamw.shape[0]
    border = torch.arange(nb, device=dev)
    corder = torch.arange(128, device=dev)
    for act in (st.active, torch.zeros_like(st.active)):
        args = (prob, st.beta, st.r, act, 0.05, 1000.0, border, corder)
        out = []
        _, kernels, _, counted, _ = trace_one_call(
            lambda: out.append(active_pass.fused_active_pass(
                *args, inner="ista", rsqr=st.rsqr)))
        bk, rk, mk, _ = out[-1]
        assert counted == 1 and len(kernels) == 1, (counted, kernels)
    assert torch.equal(bk, st.beta) and torch.equal(rk, st.r)
    assert float(mk) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gradient_sweep_kernel_matches_twin(dev, dtype):
    prob, st = _problem(dev, dtype)
    nb = prob.lamw.shape[0]
    need = torch.zeros(nb, dtype=torch.bool, device=dev)
    need[[0, 3, 4]] = True
    c_prev = torch.randn((nb, 128), dtype=dtype, device=dev)
    ck = gradient_sweep.restricted_gradient_sweep(prob.Xwb, st.r, need,
                                                  c_prev)
    cp = gradient_sweep.restricted_gradient_sweep_plain(prob.Xwb, st.r, need,
                                                        c_prev)
    torch.testing.assert_close(ck, cp, atol=100 * TOL[dtype], rtol=0)
    assert torch.equal(ck[~need], c_prev[~need])


def _check_case(dev, nb=40, B=128, *, lamw_zero=False, drift_zero=False,
                beta_zero=False, seed=0):
    """Synthetic inputs of the check kernels (no X): rows of four kinds
    (nonzero β at the KKT edge; zero β with small gradients, screened;
    zero β with one gradient at 0.99 λ, not screened; small gradients),
    drifts of 1e-3 (stale, uncertified), 1e-6 (certified) and 0, dead
    columns and a ragged last row.  ``r'y`` puts the duality gap near 0,
    so the screen's ball is small; every screen test is at least 3 % of
    its threshold from the edge, so no mask depends on the order of the
    L1 sum.  Returns phase A's arguments and
    a refreshed ``c`` for phase B."""
    rng = np.random.default_rng(seed)
    n, lam0 = 1000.0, 0.05
    valid = np.ones((nb, B))
    valid[-1, B // 2:] = 0.0
    adiag = n * (0.5 + rng.random((nb, B))) * valid
    adiag[0, :3] = 0.0
    lamw = (0.5 + rng.random((nb, B))) * valid
    if lamw_zero:
        lamw[nb // 2, 5] = 0.0          # a valid unpenalised coordinate
    lamvec = n * lam0 * lamw
    sign = rng.choice([-1.0, 1.0], (nb, B))
    kind = np.arange(nb)[:, None] % 4
    beta = np.where((kind == 0) & (rng.random((nb, B)) < 0.1),
                    0.8 / max(nb, 40) * sign, 0.0) * valid
    if beta_zero:
        beta[:] = 0.0
    c = sign * lamvec * np.where(kind % 2 == 1, 0.3, 0.6) * rng.random((nb, B))
    c = np.where(beta != 0, 0.98 * sign * lamvec, c)
    c[2::4, 7] = 0.99 * sign[2::4, 7] * lamvec[2::4, 7]
    drift = np.where(np.arange(nb) % 2 == 0, 1e-3 * (1 + rng.random(nb)), 0.0)
    drift[5::7] = 1e-6
    if drift_zero:
        drift[:] = 0.0
    rn2 = n
    ry = rn2 + n * lam0 * float(np.sum(lamw * np.abs(beta)))
    c_new = c + 0.01 * lamvec * rng.standard_normal((nb, B)) * valid

    def f(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()

    return ((f(c), f(beta), f(drift), f(adiag), f(lamw), f(valid),
             f(np.sqrt(adiag)), f(np.array([lam0, n, rn2, ry, 1e-6]))),
            f(c_new))


def _problem_case(dev):
    """The check's inputs on a mid-solve state of a real problem."""
    prob, st = _problem(dev, torch.float32)
    nb = prob.lamw.shape[0]
    c = block_cd._full_gradient_c("ls", prob, st.r, kernels=False)
    drift = torch.where(torch.arange(nb, device=dev) % 2 == 0,
                        torch.full((nb,), 1e-3, device=dev),
                        torch.zeros(nb, device=dev))
    scal = block_cd._check_scalars(0.05, 1000.0, torch.dot(st.r, st.r),
                                   torch.dot(st.r, prob.y), 1e-6)
    return (c, st.beta, drift, prob.adiag, prob.lamw, prob.valid.float(),
            prob.xwnorm, scal), c


CHECK_CASES = {
    "problem": None,
    "base": {},
    "rows_7813": dict(nb=7813),          # p = 1M: more rows than warps
    "rows_30000": dict(nb=30_000),       # past any co-resident grid
    "one_row": dict(nb=1),
    "B48": dict(B=48),
    "B50": dict(B=50),                   # B % 4 != 0: scalar loads
    "B200": dict(B=200),                 # two chunks a row
    "lamw_zero": dict(lamw_zero=True),   # the screen's ok is false
    "drift_zero": dict(drift_zero=True),
    "beta_zero": dict(beta_zero=True),
}


@pytest.mark.parametrize("case", list(CHECK_CASES))
@pytest.mark.parametrize("screen", [True, False])
def test_check_kernels_match_twins(dev, screen, case):
    """K3 and K4 against their twins: masks exactly, values to relative
    1e-5 (the kernel adds the screen's L1 norm in another order)."""
    kw = CHECK_CASES[case]
    a, c_new = _problem_case(dev) if kw is None else _check_case(dev, **kw)
    nb, B = a[0].shape
    plan = check._plan(False, nb, B, a[0].device.index)
    if case == "rows_30000":
        assert plan.rows > 1 and not plan.keep
    if case == "B200":
        assert not plan.keep
    outk = check.check_phase_a(*a, screen=screen)
    outp = check.check_phase_a_plain(*a, screen=screen)
    for i in (0, 1, 2, 5):
        assert torch.equal(outk[i], outp[i]), i
    torch.testing.assert_close(outk[3], outp[3], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(outk[4], outp[4], rtol=1e-5, atol=1e-7)
    b = (c_new, a[1], outp[3], outp[1], outp[2], a[3], a[4], a[5], a[6],
         a[7])
    mk, ak = check.check_phase_b(*b)
    mp, ap = check.check_phase_b_plain(*b)
    assert torch.equal(ak, ap)
    torch.testing.assert_close(mk, mp, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("screen", [True, False])
def test_check_kernels_are_one_launch_and_deterministic(dev, screen):
    """At the bench's 782 rows: a call of each phase is one device kernel
    and reads nothing to the host, and two calls give bitwise-equal
    outputs."""
    from coordinatedescent_jl_tpu_torch.profile_paths import trace_one_call

    a, c_new = _check_case(dev, nb=782)

    def both():
        outa = check.check_phase_a(*a, screen=screen)
        outb = check.check_phase_b(c_new, a[1], outa[3], outa[1], outa[2],
                                   a[3], a[4], a[5], a[6], a[7])
        return (*outa, *outb)

    out = []
    reads, kernels, _, counted, _ = trace_one_call(lambda: out.append(both()))
    first, second = out[0], out[-1]
    assert reads == 0
    assert counted == 2 and len(kernels) == 2, (counted, kernels)
    assert sum("check_a_kernel" in k for k in kernels) == 1, kernels
    assert sum("check_b_kernel" in k for k in kernels) == 1, kernels
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("B", [128, 100, 50, 256])
@pytest.mark.parametrize("nb", [1, 3, 8])
@pytest.mark.parametrize("screen", [True, False])
def test_check_one_cta_route_matches_cooperative_bitwise(dev, screen, nb, B):
    """At nb <= 8 the plan's grid is one CTA and K3/K4 take the plain
    one-CTA route.  Against the cooperative route forced at one CTA:
    bound, need, ub, cand, active and maxh bit for bit (the same layout,
    and the grid's sums over one CTA leave its value as it is); the
    cooperative route's masks equal the twins', its bound and maxh within
    1e-5.  B = 100 ragged, B = 50 scalar loads, B = 256 two chunks a
    row."""
    a, c_new = _check_case(dev, nb=nb, B=B)
    index = a[0].device.index
    plan_a = check._plan(False, nb, B, index)
    plan_b = check._plan(True, nb, B, index)
    assert plan_a.grid == plan_b.grid == 1 and plan_a.cta and plan_b.cta
    ref = check.check_phase_a(*a, screen=screen,
                              plan=plan_a._replace(coop=True))
    twin = check.check_phase_a_plain(*a, screen=screen)
    for i in (0, 1, 2, 5):
        assert torch.equal(ref[i], twin[i]), i
    for i in (3, 4):
        torch.testing.assert_close(ref[i], twin[i], rtol=1e-5, atol=1e-7)
    b = (c_new, a[1], ref[3], ref[1], ref[2], a[3], a[4], a[5], a[6], a[7])
    ref_b = check.check_phase_b(*b, plan=plan_b._replace(coop=True))
    twin_b = check.check_phase_b_plain(*b)
    assert torch.equal(ref_b[1], twin_b[1])
    torch.testing.assert_close(ref_b[0], twin_b[0], rtol=1e-5, atol=1e-7)
    n_a, n_b = check.cta_launches("a"), check.cta_launches("b")
    out = check.check_phase_a(*a, screen=screen)
    for i, (x, y) in enumerate(zip(out, ref)):
        assert torch.equal(x, y), i
    out_b = check.check_phase_b(*b)
    for i, (x, y) in enumerate(zip(out_b, ref_b)):
        assert torch.equal(x, y), i
    assert (check.cta_launches("a"),
            check.cta_launches("b")) == (n_a + 1, n_b + 1)


def test_check_one_cta_route_refuses_more_rows(dev):
    """The one-CTA route takes at most 8 rows: a forced launch of 9 is
    refused, not run another way."""
    a, _ = _check_case(dev, nb=9)
    n_a = check.LAUNCHES_A
    with pytest.raises(RuntimeError, match="check_a failed"):
        check.check_phase_a(*a, screen=True,
                            plan=check.CheckPlan(1, 2, False))
    assert check.LAUNCHES_A == n_a


def _cluster_shapes(dev):
    """Every cluster plan ``chip_smoke.py`` launches: K1 at the
    varying-coefficient point (n = 500, and 499 for a LOO-CV fit; f32, the
    three kinds, Gram on and off) and K5's cluster routes (the f32 block
    at n = 500 in 16 slices, the ``debug_nans`` design's 32 tiles of 2,000
    rows, the f64 blocked form's 3 slices, ``grad_f64`` at (1,000, 100)).
    Yields (C entry, its shape arguments, the cluster's CTAs)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for n in (500, 499):
        for kind in ("ls", "wls", "sqrt"):
            for gram in (True, False):
                pl = active_pass.plan_active_pass(n, 128, 4, sms, optin,
                                                  gram)
                assert pl.cluster
                yield ("cdt_active_pass_clusters_f32",
                       (active_pass._KINDS[kind], pl.smem), pl.grid)
    for entry, (nb, n, W, resplit) in (
            ("cdt_dense_sweep_f32", (1, 500, 128, True)),
            ("cdt_dense_sweep_f32", (32, 2000, 128, True)),
            ("cdt_dense_sweep_f64", (1, 500, 128, False)),
            ("cdt_grad64_f32", (1, 1000, 100, False))):
        pl = gradient_sweep.plan_dense_sweep(nb, n, W, sms, resplit)
        assert pl.cluster
        yield f"{entry}_clusters", (), pl.split


def test_cluster_plans_fit_the_card(dev):
    """The card holds at least one cluster of every shape
    ``chip_smoke.py`` plans (``cudaOccupancyMaxActiveClusters``), and the
    plans the wrappers take on it (with the largest cluster it holds) are
    the plans at 16 CTAs: on an H100 the largest cluster is 16."""
    from coordinatedescent_jl_tpu_torch.kernels import _build

    index = torch.cuda.current_device()
    for entry, shape, cluster in _cluster_shapes(dev):
        assert _build.active_clusters(entry, index, *shape, cluster) >= 1, (
            entry, shape, cluster)
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = torch.device("cuda", index)
    k1 = active_pass.card_plan(500, 128, torch.float32, card, True, "wls")
    k5 = gradient_sweep.sweep_plan(torch.empty((1, 500, 128), device=card))
    if "H100" in torch.cuda.get_device_name(index):
        assert k1 == active_pass.plan_active_pass(500, 128, 4, sms, optin)
        assert k5 == gradient_sweep.plan_dense_sweep(1, 500, 128, sms, True)
        for kind in range(3):
            assert _build.largest_cluster(
                "cdt_active_pass_clusters_f32", index, kind, optin) == 16
    assert k1.grid <= _build.largest_cluster(
        "cdt_active_pass_clusters_f32", index, 1, optin)


def test_small_n_routes_are_one_kernel_and_no_host_read(dev):
    """At the varying-coefficient point K1 (wls, both inners) and K5 each
    launch one device kernel a call and read nothing to the host.  (After
    the file's other one-call traces: a trace taken before the heavy
    solves of test_solve_kinds_kernels_match_plain made the tracer drop
    the first kernel of every later trace in the process.)"""
    from coordinatedescent_jl_tpu_torch.profile_paths import trace_one_call

    prob, st, lam0 = _vc_point(dev)
    one = torch.arange(1, device=dev)
    corder = torch.arange(128, device=dev)
    act = torch.ones(1, dtype=torch.bool, device=dev)
    for inner in ("ista", "exact"):
        reads, names, _, counted, _ = trace_one_call(
            lambda: active_pass.fused_active_pass(
                prob, st.beta, st.r, act, lam0, 500.0, one, corder,
                kind="wls", inner=inner, rsqr=st.rsqr))
        assert (reads, len(names), counted) == (0, 1, 1), names
    reads, names, _, counted, _ = trace_one_call(
        lambda: gradient_sweep.fused_gradient_sweep(prob.Xwb, st.r))
    assert (reads, len(names), counted) == (0, 1, 1), names


def test_check_one_cta_route_is_one_kernel_and_no_host_read(dev):
    """At one block (the varying-coefficient point's nb) and at 8, K3
    (screen on and off) and K4 each launch one plain one-CTA kernel a call
    and read nothing to the host.  (With the file's other one-call traces,
    after the heavy tests.)"""
    from coordinatedescent_jl_tpu_torch.profile_paths import trace_one_call

    for nb in (1, 8):
        a, c_new = _check_case(dev, nb=nb)
        for screen in (True, False):
            reads, names, _, counted, _ = trace_one_call(
                lambda: check.check_phase_a(*a, screen=screen))
            assert (reads, len(names), counted) == (0, 1, 1), names
            assert "check_a_cta" in names[0], names
        outa = check.check_phase_a(*a, screen=True)
        b = (c_new, a[1], outa[3], outa[1], outa[2], a[3], a[4], a[5], a[6],
             a[7])
        reads, names, _, counted, _ = trace_one_call(
            lambda: check.check_phase_b(*b))
        assert (reads, len(names), counted) == (0, 1, 1), names
        assert "check_b_cta" in names[0], names


# ---- the p = 1M shapes of bench.py:1098-1193 (n = 1,000, 7,813 blocks of
# 128), with the file's other one-call traces: after the heavy tests of the
# kinds, before the solves below


def test_dense_sweep_at_the_p1m_shape(dev):
    """K5 at (7,813, 1,000, 128) f32 (the blocked p = 1M design): within
    1e-5 of max|c| of the twin, one call its plan's route (one kernel, or
    two where the rows split outside a cluster) and no host read."""
    from coordinatedescent_jl_tpu_torch.profile_paths import trace_one_call

    g = torch.Generator(device=dev).manual_seed(0)
    Xwb = torch.randn((7813, 1000, 128), generator=g, device=dev)
    r = torch.randn(1000, generator=g, device=dev)
    ck = gradient_sweep.fused_gradient_sweep(Xwb, r)
    cp = gradient_sweep.fused_gradient_sweep_plain(Xwb, r)
    assert float((ck - cp).abs().max()) <= 1e-5 * float(cp.abs().max())
    plan = gradient_sweep.sweep_plan(Xwb)
    reads, names, _, counted, _ = trace_one_call(
        lambda: gradient_sweep.fused_gradient_sweep(Xwb, r))
    two = plan.split > 1 and not plan.cluster
    assert (reads, len(names), counted) == (0, 1 + two, 1), names
    head = names[0].split("(")[0].replace(" ", "")
    assert "sweep_kernel" in head and head.endswith("true>") == plan.cluster


def test_active_pass_cluster_route_at_n_1000(dev):
    """K1′ at n = 1,000 (the p = 1M solve's rows): the cluster route of 16
    CTAs of 63 rows, 8 blocks with cached Grams, ls, f32, FISTA, against
    the twin and bit for bit against the cooperative route at the same
    CTAs and rows; one traced call is one cluster-route kernel and no host
    read."""
    from coordinatedescent_jl_tpu_torch.profile_paths import trace_one_call

    prob, st = _problem(dev, torch.float32, n=1000, p=1000, gram=True)
    nb = prob.lamw.shape[0]
    plan = active_pass.card_plan(1000, 128, torch.float32, dev, True, "ls")
    assert plan.cluster and (plan.grid, plan.rows) == (16, 63), plan
    args = (prob, st.beta, st.r, torch.ones(nb, dtype=torch.bool, device=dev),
            0.05, 1000.0, torch.arange(nb, device=dev),
            torch.arange(128, device=dev))
    kw = dict(kind="ls", inner="ista", iters=16, rsqr=st.rsqr)
    bk, rk, mk, _ = active_pass.fused_active_pass(*args, **kw)
    bp, rp, mp, _ = active_pass.fused_active_pass_plain(*args, **kw)
    tol = TOL[torch.float32]
    torch.testing.assert_close(bk, bp, atol=tol, rtol=0)
    torch.testing.assert_close(rk, rp, atol=10 * tol, rtol=0)
    torch.testing.assert_close(mk, mp, atol=tol, rtol=0)
    coop = active_pass.fused_active_pass(
        *args, **kw, plan=active_pass.on_route(plan, False, 128, 4))
    assert all(torch.equal(a, c) for a, c in zip((bk, rk, mk), coop[:3]))
    reads, names, _, counted, _ = trace_one_call(
        lambda: active_pass.fused_active_pass(*args, **kw))
    assert (reads, len(names), counted) == (0, 1, 1), names
    assert names[0].split("(")[0].replace(" ", "").endswith("true>"), names


def test_check_kernels_at_7813_rows_are_the_cooperative_route(dev):
    """K3 (screen on and off) and K4 at 7,813 rows (the p = 1M check):
    the twins' masks, and one traced call is one cooperative kernel
    (``check_a_kernel`` / ``check_b_kernel``) and no host read."""
    from coordinatedescent_jl_tpu_torch.profile_paths import trace_one_call

    a, c_new = _check_case(dev, nb=7813)
    assert not check._plan(False, 7813, 128, dev.index or 0).cta
    for screen in (True, False):
        outk = check.check_phase_a(*a, screen=screen)
        outp = check.check_phase_a_plain(*a, screen=screen)
        for i in (0, 1, 2, 5):
            assert torch.equal(outk[i], outp[i]), i
        reads, names, _, counted, _ = trace_one_call(
            lambda: check.check_phase_a(*a, screen=screen))
        assert (reads, len(names), counted) == (0, 1, 1), names
        assert "check_a_kernel" in names[0], names
    b = (c_new, a[1], outp[3], outp[1], outp[2], a[3], a[4], a[5], a[6],
         a[7])
    mk, ak = check.check_phase_b(*b)
    mp, ap = check.check_phase_b_plain(*b)
    assert torch.equal(ak, ap)
    torch.testing.assert_close(mk, mp, rtol=1e-5, atol=1e-7)
    reads, names, _, counted, _ = trace_one_call(lambda: check.check_phase_b(*b))
    assert (reads, len(names), counted) == (0, 1, 1), names
    assert "check_b_kernel" in names[0], names


def test_launch_counts_by_shape(dev):
    """The wrappers' counts by shape and route (chip_smoke.py reads 4m's
    p = 1M rows from them): one launch each of K5, K3, K4 and K1 adds one
    under its key and nothing elsewhere; ``reset_launch_counts`` clears
    them."""
    from coordinatedescent_jl_tpu_torch.profile_paths import (
        reset_launch_counts)

    reset_launch_counts()
    g = torch.Generator(device=dev).manual_seed(0)
    Xwb = torch.randn((3, 200, 128), generator=g, device=dev)
    gradient_sweep.fused_gradient_sweep(Xwb, torch.randn(200, generator=g,
                                                         device=dev))
    assert dict(gradient_sweep.LAUNCHES_DENSE_SHAPE) == {(3, 200): 1}
    a, c_new = _check_case(dev, nb=20)
    out = check.check_phase_a(*a, screen=True)
    check.check_phase_b(c_new, a[1], out[3], out[1], out[2], a[3], a[4],
                        a[5], a[6], a[7])
    index = a[0].device.index
    assert dict(check.LAUNCHES_SHAPE) == {
        ("a", 20, check._plan(False, 20, 128, index).cta): 1,
        ("b", 20, check._plan(True, 20, 128, index).cta): 1}
    prob, st = _problem(dev, torch.float32, n=1000, p=300, gram=True)
    nb = prob.lamw.shape[0]
    active_pass.fused_active_pass(
        prob, st.beta, st.r, torch.ones(nb, dtype=torch.bool, device=dev),
        0.05, 1000.0, torch.arange(nb, device=dev),
        torch.arange(128, device=dev), kind="ls", inner="ista", iters=4,
        rsqr=st.rsqr)
    plan = active_pass.card_plan(1000, 128, torch.float32, dev, True, "ls")
    assert dict(active_pass.LAUNCHES_SHAPE) == {
        ("ls", False, 1000, plan.cluster): 1}
    reset_launch_counts()
    assert not (gradient_sweep.LAUNCHES_DENSE_SHAPE or check.LAUNCHES_SHAPE
                or active_pass.LAUNCHES_SHAPE)


def test_lasso_kernels_match_plain_path(dev):
    rng = np.random.default_rng(5)
    n, p = 400, 3000
    X = torch.as_tensor(rng.standard_normal((n, p)), dtype=torch.float32,
                        device=dev)
    beta = np.zeros(p)
    beta[rng.choice(p, 12, replace=False)] = 1.0 + rng.random(12)
    y = X @ torch.as_tensor(beta, dtype=torch.float32, device=dev)
    opts = CDOptions(opt_tol=1e-6, randomize=False, compact_size=256)
    counts = (active_pass.LAUNCHES_KIND["ls"][0], gradient_sweep.LAUNCHES,
              check.LAUNCHES_A)
    sk = lasso(X, y, 0.1, options=opts)
    assert active_pass.LAUNCHES_KIND["ls"][0] > counts[0]
    assert check.LAUNCHES_A > counts[2]
    sp = lasso(X, y, 0.1, options=opts.replace(use_pallas=False))
    torch.testing.assert_close(sk.x, sp.x, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [128, 48])
@pytest.mark.parametrize("n, p, split", [(1000, 700, True),
                                         (256, 600 * 128, False)])
def test_dense_sweep_kernel_matches_twin(dev, dtype, B, n, p, split):
    """K5 on the blocked layout: every block, a ragged row tail; few
    column tiles split the rows (a second, fixed-order pass), 600 tiles or
    more do not (one launch, no partials)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = gradient_sweep.plan_dense_sweep(-(-p // B), n, B, sms)
    assert (plan.split > 1) == split
    prob, st = _problem(dev, dtype, n=n, p=p, B=B)
    n0 = gradient_sweep.LAUNCHES_DENSE
    ck = gradient_sweep.fused_gradient_sweep(prob.Xwb, st.r)
    torch.cuda.synchronize()
    assert gradient_sweep.LAUNCHES_DENSE == n0 + 1
    cp = gradient_sweep.fused_gradient_sweep_plain(prob.Xwb, st.r)
    torch.testing.assert_close(ck, cp, atol=100 * TOL[dtype], rtol=0)
    # the engine's dense refresh launches it with the kernels on
    block_cd._full_gradient_c("ls", prob, st.r, kernels=True)
    assert gradient_sweep.LAUNCHES_DENSE == n0 + 2


@pytest.mark.parametrize("xdtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [700, 100, 701])
def test_grad_f64_kernel_matches_twin(dev, xdtype, p):
    """K5's f64-accumulating instantiation on the dense (n, p) design: a
    ragged last column tile (p = 700), a design narrower than one tile
    (p = 100), and rows whose byte stride is not a multiple of 16
    (p = 701: the kernel's scalar loads)."""
    rng = np.random.default_rng(2)
    X = torch.as_tensor(rng.standard_normal((1000, p)), dtype=xdtype,
                        device=dev)
    r = torch.as_tensor(rng.standard_normal(1000), dtype=torch.float64,
                        device=dev)
    n0 = gradient_sweep.LAUNCHES_F64
    gk = gradient_sweep.grad_f64(X, r)
    torch.cuda.synchronize()
    assert gradient_sweep.LAUNCHES_F64 == n0 + 1 and gk.dtype == torch.float64
    gp = gradient_sweep.grad_f64_plain(X, r)
    torch.testing.assert_close(gk, gp, atol=1e-10 * float(gp.abs().max()),
                               rtol=0)


def _path_problem(dev, n=400, p=3000, s=12, seed=5):
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.standard_normal((n, p)), dtype=torch.float32,
                        device=dev)
    beta = np.zeros(p)
    beta[rng.choice(p, s, replace=False)] = 1.0 + rng.random(s)
    y = X @ torch.as_tensor(beta, dtype=torch.float32, device=dev)
    y = y + 0.1 * torch.as_tensor(rng.standard_normal(n),
                                  dtype=torch.float32, device=dev)
    lam_max = float(torch.max(torch.abs(y @ X)) / n)
    return X, y, lam_max


def test_batched_path_kernels_match_scan(dev):
    """The batched path (f32, kernels) certifies without falling back and
    agrees with the scan and with its own plain run in support."""
    import warnings

    X, y, lam_max = _path_problem(dev)
    lams = lam_max * np.geomspace(0.5, 0.05, 20)
    opts = CDOptions(opt_tol=1e-6, randomize=False, compact_size=256)
    n0 = gradient_sweep.LAUNCHES_DENSE
    u0 = union_fista.LAUNCHES
    st = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        pb = lasso_path(X, y, lams, options=opts, standardize_X=False,
                        path_batch=128, stats=st)
        pp = lasso_path(X, y, lams, options=opts.replace(use_pallas=False),
                        standardize_X=False, path_batch=128)
    assert st["used_batched"] and st["batched_certified"]
    assert gradient_sweep.LAUNCHES_DENSE > n0
    # one union-fista launch a refine round, none from the plain run
    assert st["refine_rounds"] >= 1
    assert union_fista.LAUNCHES - u0 == st["refine_rounds"]
    ps = lasso_path(X, y, lams, options=opts, standardize_X=False,
                    path_batch=0)
    for other in (ps.beta_path, pp.beta_path):
        a, b = pb.beta_path, other
        differ = ((a != 0) != (b != 0)) & (torch.maximum(a.abs(), b.abs())
                                          > 1e-4)
        assert int(differ.sum()) == 0
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def _union_round(dev, dtype, k, Cp, B, n, seed=0):
    """Lanes of one refine round over a union Gram of real Gaussian
    columns: ``(Ks, thr, Bs0, cs0, cert)``, the last column a padded slot
    (zero column, threshold ``finfo.max / 8``, coefficient 0), every 4th
    lane certified, thresholds at each lane's 70-95 % quantile of |cs0| so
    that a few percent of the coordinates enter."""
    rng = np.random.default_rng(seed)
    Xs = rng.standard_normal((n, Cp))
    Xs[:, -1] = 0.0
    R = rng.standard_normal((k, n))
    Bs0 = rng.standard_normal((k, Cp)) * (rng.random((k, Cp)) < 0.05)
    Bs0[:, -1] = 0.0
    cs0 = R @ Xs
    q = [np.quantile(np.abs(c[:-1]), u)
         for c, u in zip(cs0, rng.uniform(0.7, 0.95, k))]
    thr = np.asarray(q)[:, None] * (0.5 + rng.random((k, Cp)))
    thr[:, -1] = torch.finfo(dtype).max / 8
    cert = np.arange(k) % 4 == 1
    t = [torch.as_tensor(a, dtype=dtype, device=dev)
         for a in (Xs.T @ Xs, thr, Bs0, cs0)]
    return (*t, torch.as_tensor(cert, device=dev))


# (k, Cp, block, n, block_iters, sweeps): the CPU tests' case, and the
# batched path's round in the lasso_path100 cell (98 lanes, compact_size
# 1,024, blocks of 128, 16 steps, 8 sweeps) on n = 10,000 rows
UNION_CASES = {"unit": (5, 48, 16, 50, 7, 3),
               "cell": (98, 1024, 128, 10_000, 16, 8)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(UNION_CASES))
def test_union_fista_kernel_matches_twin(dev, dtype, case):
    """The union-block FISTA kernel against its plain twin, on the card.
    f64 within 1e-10 of max |bs|: the sums run in another order than
    cuBLAS's, over 3-8 sweeps of dependent steps.  f32 within 1e-4 of max
    |bs|: the same, at float32's rounding.  Certified lanes are ``Bs0``
    bit for bit, the padded slot stays 0, one launch a call."""
    k, Cp, B, n, iters, sweeps = UNION_CASES[case]
    args = _union_round(dev, dtype, k, Cp, B, n)
    opts = CDOptions(block_size=B, block_iters=iters)
    before = union_fista.LAUNCHES
    out = union_fista.fused_union_fista(*args, opts, n_sweeps=sweeps)
    torch.cuda.synchronize()
    assert union_fista.LAUNCHES == before + 1
    ref = batched_certify.union_block_fista_plain(*args, opts,
                                                  n_sweeps=sweeps)
    Bs0, cert = args[2], args[4]
    assert torch.equal(out[cert], Bs0[cert])
    assert torch.all(out[:, -1] == 0)
    moved = ~cert & torch.any(ref != Bs0, dim=1)
    assert bool(torch.all(moved == ~cert))
    tol = (1e-10 if dtype == torch.float64 else 1e-4) * float(
        ref.abs().max())
    torch.testing.assert_close(out, ref, atol=tol, rtol=0)
    # the dispatcher takes the kernel under the mode rule, the twin with
    # use_pallas=False
    out2 = batched_certify.union_block_fista(*args, opts, n_sweeps=sweeps)
    assert union_fista.LAUNCHES == before + 2 and torch.equal(out2, out)
    batched_certify.union_block_fista(*args, opts.replace(use_pallas=False),
                                      n_sweeps=sweeps)
    assert union_fista.LAUNCHES == before + 2


@pytest.mark.parametrize("case", ["wide_block", "ragged", "strided"])
def test_union_fista_kernel_refuses_other_shapes(dev, case):
    """A block wider than 128, a ``Cp`` the block does not divide, and a
    non-contiguous input raise before any launch."""
    Ks, thr, Bs0, cs0, cert = _union_round(dev, torch.float32, 4, 256, 128,
                                           300)
    B = 128
    if case == "wide_block":
        B = 256
    elif case == "ragged":
        B = 96
    else:
        cs0 = cs0.T.contiguous().T
    before = union_fista.LAUNCHES
    with pytest.raises(ValueError, match="union-fista kernel"):
        union_fista.fused_union_fista(Ks, thr, Bs0, cs0, cert,
                                      CDOptions(block_size=B), n_sweeps=2)
    assert union_fista.LAUNCHES == before


# ---- the varying-coefficient round (csrc/vc_round.cu), with the other
# refine round's tests: after the one-call traces above (heavy card work
# before them left their traces empty)


def _vc_round_lanes(dev, dtype, degree, k, loo, seed=3):
    """``k`` lanes of ``_VcBatchOps`` at n = 500, p = 50 (float32) or n =
    300, p = 40 (float64, where X still fits in shared memory), 16 steps:
    grid lanes over z0 in [0.05, 0.95], or LOO-CV lanes (each lane's own
    row at zero weight) at rows 0, 1, ...; thresholds λ·σ with a per-lane
    σ; random sparse starts; every 5th lane certified (frozen); the stall
    counters one below the patience in every 3rd lane, whose ``best`` is
    below its max (no improvement).  ``tol`` is set to the geometric mean
    of two neighbouring per-lane maxima of the twin's round near their
    median, so no lane's max sits at ``tol`` or ``4 tol``."""
    from coordinatedescent_jl_tpu_torch import GaussianKernel
    from coordinatedescent_jl_tpu_torch.models import varying_coefficient

    n, p = (500, 50) if dtype == torch.float32 else (300, 40)
    rng = np.random.default_rng(seed)
    z = torch.as_tensor(rng.uniform(0, 1, n), dtype=dtype, device=dev)
    X = torch.as_tensor(rng.standard_normal((n, p)), dtype=dtype, device=dev)
    y = torch.sin(2 * np.pi * z) * X[:, 0] + 0.3 * torch.as_tensor(
        rng.standard_normal(n), dtype=dtype, device=dev)
    idx = torch.arange(k, device=dev) % n if loo else None
    z0 = z[idx] if loo else torch.linspace(0.05, 0.95, k, dtype=dtype,
                                           device=dev)
    opts = CDOptions(stall_patience=3)
    ops = varying_coefficient._VcBatchOps(X, z, y, GaussianKernel(0.1), z0,
                                          degree, opts, holdout=idx)
    sig = torch.as_tensor(0.5 + rng.random(k), dtype=dtype, device=dev)
    thrw = (ops.lamw * varying_coefficient._thr_scale(0.05, n, dtype)
            * sig[:, None]).contiguous()
    B = torch.as_tensor(0.3 * rng.standard_normal((k, ops.ep))
                        * (rng.random((k, ops.ep)) < 0.2), dtype=dtype,
                        device=dev)
    lane = torch.arange(k, device=dev)
    cert = lane % 5 == 2
    stall = torch.where(lane % 3 == 0, 2, 0).to(torch.int32)
    esc = lane % 7 == 6
    mx0 = ops.round_plain(B, cert, torch.full((k,), np.inf, dtype=dtype,
                                              device=dev),
                          stall, esc, thrw)[2]
    best = torch.where(lane % 3 == 0, 0.5 * mx0, 2.0 * mx0)
    m = np.sort(mx0.double().cpu().numpy())
    i = len(m) // 2
    tol = float(np.sqrt(m[i] * m[i - 1])) if len(m) > 1 else 0.5 * m[0]
    ops.opts = opts.replace(opt_tol=tol)
    return ops, (B, cert, best, stall, esc, thrw)


@pytest.mark.parametrize("loo", [False, True])
@pytest.mark.parametrize("route", [0, 1])
@pytest.mark.parametrize("k", [1, 94, 128, 200])
@pytest.mark.parametrize("degree", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vc_round_kernel_matches_twin(dev, dtype, degree, k, route, loo):
    """The varying-coefficient round's kernel on either route of X against
    its plain twin: one launch; B within 1e-4 (float32) / 1e-10 (float64)
    of max |B| and R within that of max |y| (the products' sums run in
    another order than cuBLAS's, through 16 dependent steps), the per-lane
    max within 1e-3 / 1e-8 relative, cert, stall and esc exact, and a
    certified lane's coefficients the twin's bit for bit."""
    ops, state = _vc_round_lanes(dev, dtype, degree, k, loo)
    B, cert = state[0], state[1]
    before = vc_round.LAUNCHES
    out = vc_round.fused_vc_round(ops, *state, route=route)
    torch.cuda.synchronize()
    assert vc_round.LAUNCHES == before + 1
    ref = ops.round_plain(*state)
    f32 = dtype == torch.float32
    assert torch.equal(out[0][cert], ref[0][cert])
    assert torch.equal(out[0][cert], (B * ops.sc / ops.sc)[cert])
    tol = 1e-4 if f32 else 1e-10
    torch.testing.assert_close(out[0], ref[0], rtol=0,
                               atol=tol * float(ref[0].abs().max()))
    torch.testing.assert_close(out[1], ref[1], rtol=0,
                               atol=tol * float(ops.y.abs().max()))
    torch.testing.assert_close(out[2], ref[2], rtol=1e-3 if f32 else 1e-8,
                               atol=1e-30)
    for i, name in ((3, "cert"), (5, "stall"), (6, "esc")):
        assert out[i].dtype == ref[i].dtype and torch.equal(out[i], ref[i]), \
            name
    torch.testing.assert_close(out[4], ref[4], rtol=1e-3 if f32 else 1e-8,
                               atol=1e-30)
    # the dispatcher takes the kernel on the card, the twin with
    # use_pallas=False
    ops.round(*state)
    assert vc_round.LAUNCHES == before + 2
    ops.opts = ops.opts.replace(use_pallas=False)
    ops.round(*state)
    assert vc_round.LAUNCHES == before + 2


def test_vc_round_kernel_refuses_what_does_not_fit(dev):
    """Where not even route 1 fits the card's shared memory (p·q1 = 24,000
    coordinates a lane), the wrapper raises before any launch: a CUDA
    tensor never falls back to the twin."""
    from coordinatedescent_jl_tpu_torch import GaussianKernel
    from coordinatedescent_jl_tpu_torch.models import varying_coefficient

    g = torch.Generator(device=dev).manual_seed(0)
    n, p, k = 40, 8000, 2
    X = torch.randn((n, p), generator=g, device=dev)
    z = torch.rand((n,), generator=g, device=dev)
    y = torch.randn((n,), generator=g, device=dev)
    ops = varying_coefficient._VcBatchOps(
        X, z, y, GaussianKernel(0.2), z[:k], 2, CDOptions())
    state = (torch.zeros((k, ops.ep), device=dev),
             torch.zeros((k,), dtype=torch.bool, device=dev),
             torch.ones((k,), device=dev),
             torch.zeros((k,), dtype=torch.int32, device=dev),
             torch.zeros((k,), dtype=torch.bool, device=dev),
             ops.lamw.contiguous())
    before = vc_round.LAUNCHES
    with pytest.raises(ValueError, match="vc-round kernel"):
        ops.round(*state)
    assert vc_round.LAUNCHES == before


def test_vc_grid_rounds_are_kernel_launches_at_the_cell_shape(dev):
    """One ``locpolyl1`` fit at the varying-coefficient cell's shape (n =
    500, p = 50, degree 1, 1000 grid points, 128 lanes, float32)
    certifies every lane with one round kernel launch a refine round, and
    its coefficients agree with the plain rounds' in support (no
    coordinate above 1e-4 in one and not the other) and within 1e-4."""
    import warnings

    from coordinatedescent_jl_tpu_torch import GaussianKernel, locpolyl1
    from coordinatedescent_jl_tpu_torch.profile_paths import vc_bench_problem

    vp = vc_bench_problem(dev)
    kern = GaussianKernel(vp.h)
    st, sp = {}, {}
    before = vc_round.LAUNCHES
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        ok_, _ = locpolyl1(vp.X, vp.z, vp.y, vp.zgrid, 1, kern, vp.lam0,
                           grid_batch=128, stats=st)
        op, _ = locpolyl1(vp.X, vp.z, vp.y, vp.zgrid, 1, kern, vp.lam0,
                          options=CDOptions(use_pallas=False),
                          grid_batch=128, stats=sp)
    assert st["used_batched"] and st["batched_certified"]
    assert sp["batched_certified"]
    assert st["refine_rounds"] >= 8
    assert vc_round.LAUNCHES - before == st["refine_rounds"]
    differ = ((ok_ != 0) != (op != 0)) & (torch.maximum(ok_.abs(), op.abs())
                                          > 1e-4)
    assert int(differ.sum()) == 0
    torch.testing.assert_close(ok_, op, atol=1e-4, rtol=0)


def test_refit_lasso_path_runs_on_the_card(dev):
    """The refits are solved on the card (one host read, for the supports)
    and agree with numpy's least squares on the host."""
    from coordinatedescent_jl_tpu_torch import refit_lasso_path
    from coordinatedescent_jl_tpu_torch.utils import host

    X, y, lam_max = _path_problem(dev, seed=8)
    path = lasso_path(X, y, lam_max * np.array([0.5, 0.2, 0.1]),
                      options=CDOptions(opt_tol=1e-6), standardize_X=False,
                      path_batch=0)
    reads = host.COUNTS["host_reads"]
    out = refit_lasso_path(path, X, y)
    assert host.COUNTS["host_reads"] == reads + 1
    assert len(out) >= 2
    Xn, yn = X.cpu().numpy().astype(np.float64), y.cpu().numpy()
    for S, coef in out.items():
        assert coef.is_cuda and coef.dtype == torch.float32
        ref = np.linalg.lstsq(Xn[:, list(S)], yn, rcond=None)[0]
        np.testing.assert_allclose(coef.cpu().numpy(), ref, atol=1e-4)


def test_polish_kernels_reach_target_gap(dev):
    """lasso (kernels) then polish_lasso: K1 (f64 exact inner) and K5's f64
    instantiation launch, and the polished gap is <= 1e-7."""
    X, y, lam_max = _path_problem(dev, seed=6)
    lam = 0.05 * lam_max
    sol = lasso(X, y, lam, options=CDOptions(opt_tol=1e-6))
    k1 = active_pass.LAUNCHES_KIND["ls"]
    n1, n5 = k1[1], gradient_sweep.LAUNCHES_F64
    res = polish_lasso(X, y, sol.x, lam)
    assert res.converged and res.rel_gap <= 1e-7
    assert k1[1] > n1 and gradient_sweep.LAUNCHES_F64 > n5
    gap, primal = lasso_duality_gap_compensated(X, y, res.beta, lam)
    assert gap / primal <= 1.1e-7
    gp, pp = lasso_duality_gap_compensated(X.cpu(), y.cpu(), res.beta.cpu(),
                                           lam, device="cpu")
    assert abs(gap - gp) <= 1e-9 * abs(gp) + 1e-15 * pp


def _group_data(dev, n, p, G, n_act, seed=0):
    """bench.py's group problem at a small size: ``n_act`` groups of G set
    to 1.0, noise 0.3, λ = 0.3·group-λmax; float32 on the card."""
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.standard_normal((n, p)), dtype=torch.float32,
                        device=dev)
    ng = -(-p // G)
    beta = np.zeros(ng * G)
    for g in rng.choice(p // G, n_act, replace=False):
        beta[g * G:(g + 1) * G] = 1.0
    y = X @ torch.as_tensor(beta[:p], dtype=torch.float32, device=dev)
    y = y + 0.3 * torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                                  device=dev)
    c = torch.nn.functional.pad(y @ X, (0, ng * G - p)).reshape(ng, G)
    lam = 0.3 * float(torch.max(torch.linalg.vector_norm(c, dim=1)) / n)
    return X, y, lam


def _launches():
    from coordinatedescent_jl_tpu_torch.profile_paths import launch_counts

    return launch_counts()


@pytest.mark.parametrize("G", [5, 8, 130])
def test_group_engine_kernels_match_plain(dev, G):
    """The group engine on the card: its full sweeps launch K5 at block
    width B = 125, 128 and 130 (K5 held against its twin at that width
    too), its active passes the group pass kernel GP where B <= 128 (G = 5
    and 8; at G = 130 the plain twin), never K1-K4; the plain run
    (``use_pallas=False``) launches nothing and reaches the same group
    support; p = 3127 leaves a ragged tail group."""
    from coordinatedescent_jl_tpu_torch import group_lasso
    from coordinatedescent_jl_tpu_torch.ops import group_cd

    X, y, lam = _group_data(dev, 2000, 3127, G, 6, seed=G)
    opts = CDOptions(opt_tol=1e-6, randomize=False)
    B = group_cd._block_width(G)
    assert B == {5: 125, 8: 128, 130: 130}[G]
    prob = group_cd._build_group_problem(X, y, torch.ones(-(-3127 // G),
                                                          device=dev), G)
    assert prob.Xwb is prob.Xb and prob.Xb.shape[2] == B
    r = y - 0.01 * y.flip(0)
    ck = gradient_sweep.fused_gradient_sweep(prob.Xwb, r)
    cp = gradient_sweep.fused_gradient_sweep_plain(prob.Xwb, r)
    torch.testing.assert_close(ck, cp, rtol=0,
                               atol=1e-5 * float(cp.abs().max()))
    del prob
    before = _launches()
    sol = group_lasso(X, y, lam, G, options=opts)
    mid = _launches()
    sol_p = group_lasso(X, y, lam, G, options=opts.replace(use_pallas=False))
    after = _launches()
    ran = {k: mid[k] - before[k] for k in mid}
    launched = ("K5", "GP") if B <= 128 else ("K5",)
    assert all(ran[k] > 0 for k in launched), ran
    assert all(v == 0 for k, v in ran.items() if k not in launched), ran
    assert after == mid
    a, b = sol.x, sol_p.x
    assert a.is_cuda and a.dtype == torch.float32
    big = torch.maximum(a.abs(), b.abs()) > 1e-4
    assert int((((a != 0) != (b != 0)) & big).sum()) == 0
    assert int((a != 0).sum()) >= G
    torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def _group_pass_case(dev, dtype, G, kind, seed=0, p=None, zero_weight=False,
                     none_active=False):
    """A group problem and a mid-solve state for one active pass: n = 300,
    five blocks of B = k·G lanes (``p`` columns: a ragged tail group where
    G does not divide it), random group weights (one set to 0 with
    ``zero_weight``), about a third of the groups non-zero, every block
    but one active (none with ``none_active``), λ0 at 0.2 of the group
    λmax.  Returns ``(prob, st, lam0, n_scale)``."""
    from coordinatedescent_jl_tpu_torch.ops import group_cd

    rng = np.random.default_rng(seed)
    n, B = 300, group_cd._block_width(G)
    p = 5 * B if p is None else p
    ng = -(-p // G)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    X = rng.standard_normal((n, p))
    y = X[:, :3 * G] @ rng.standard_normal(3 * G) + rng.standard_normal(n)
    lamw = 0.5 + rng.random(ng)
    if zero_weight:
        lamw[1] = 0.0
    w = t(0.5 + rng.random(n)) if kind == "wls" else None
    prob = group_cd._build_group_problem(t(X), t(y), t(lamw), G, w)
    nb, Bp = prob.valid.shape
    on = np.repeat(rng.random(nb * Bp // G) < 0.35, G)
    beta = t(rng.standard_normal(nb * Bp) * on).reshape(nb, Bp) * prob.valid
    st = group_cd._group_init(prob, beta.contiguous(),
                              torch.Generator().manual_seed(seed))
    act = torch.ones(nb, dtype=torch.bool, device=dev)
    act[2] = False
    if none_active:
        act[:] = False
    st = st._replace(active=act)
    n_scale = (torch.sqrt(torch.clamp_min(torch.dot(st.r, st.r), 1e-30))
               if kind == "sqrt" else float(n))
    c = group_cd._full_sweep(prob, prob.y, False)
    cg = torch.where(prob.valid, c, 0.0).reshape(nb, Bp // G, G)
    lmax = torch.linalg.vector_norm(cg, dim=2) / (
        n_scale * torch.clamp_min(prob.lamw, 1e-30))
    return prob, st, 0.2 * float(lmax.max()), n_scale


def _hold_group_pass(prob, st, lam0, n_scale, randomize, G):
    """The engine's kernel pass against ``_group_active_pass_plain`` on the
    same state and the same draws of the order: one launch, no host read,
    the same zero / non-zero groups, β, r and maxh within the dtype's
    tolerance of each one's largest magnitude (float32 1e-5: sums in
    another order through 16 dependent steps; float64 1e-12), and a second
    launch on the same inputs bit for bit the first."""
    from coordinatedescent_jl_tpu_torch.kernels import group_pass
    from coordinatedescent_jl_tpu_torch.ops import group_cd
    from coordinatedescent_jl_tpu_torch.ops.prox import fista_momentum
    from coordinatedescent_jl_tpu_torch.utils import host

    dtype = st.beta.dtype
    coefs = fista_momentum(16, dtype)
    seed_state = st.key.get_state()
    launches, reads = group_pass.LAUNCHES, host.COUNTS["host_reads"]
    sk, mk = group_cd._group_active_pass(prob, st, lam0, n_scale, randomize,
                                         coefs, True)
    assert group_pass.LAUNCHES == launches + 1
    assert host.COUNTS["host_reads"] == reads
    st.key.set_state(seed_state)
    sp, mp = group_cd._group_active_pass_plain(prob, st, lam0, n_scale,
                                               randomize, coefs)
    st.key.set_state(seed_state)
    sk2, mk2 = group_cd._group_active_pass(prob, st, lam0, n_scale,
                                           randomize, coefs, True)
    assert (torch.equal(sk.beta, sk2.beta) and torch.equal(sk.r, sk2.r)
            and torch.equal(mk, mk2))
    assert sk.beta.is_cuda and sk.beta.dtype == dtype

    def groups(b):
        return torch.any(b.reshape(-1, G) != 0, dim=1)

    assert torch.equal(groups(sk.beta), groups(sp.beta))
    assert torch.equal(sk.active, sp.active)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    bmax = float(sp.beta.abs().max())
    for a, b in ((sk.beta, sp.beta), (sk.r, sp.r), (mk, mp)):
        scale = bmax if a is mk else float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=tol * max(scale, 1e-30))
    return sk, sp, mk


@pytest.mark.parametrize("randomize", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["ls", "wls", "sqrt"])
@pytest.mark.parametrize("G", [1, 4, 5, 8, 16, 128])
def test_group_pass_kernel_matches_twin(dev, G, kind, dtype, randomize):
    """GP against the plain twin at every group width the kernel takes:
    groups within a warp's coordinates (G = 1, 4, 8: the shuffle norm) and
    across warps (G = 5, 16, 128: the shared-memory norm; B = 125 at G =
    5), each kind, both dtypes, the order drawn or in sequence."""
    prob, st, lam0, n_scale = _group_pass_case(dev, dtype, G, kind, seed=G)
    sk, _, _ = _hold_group_pass(prob, st, lam0, n_scale, randomize, G)
    assert not torch.equal(sk.beta, st.beta)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["zero_weight", "ragged_tail", "no_active"])
def test_group_pass_kernel_edge_cases(dev, case, dtype):
    """GP against the plain twin with a zero-weight group (its prox the
    identity), with a ragged tail group (p = 5·125 − 3 at G = 5: the last
    group holds 2 real columns, the padded lanes stay 0), and with no
    active block (one launch that leaves β and r as they were, maxh 0)."""
    G = 5 if case == "ragged_tail" else 8
    prob, st, lam0, n_scale = _group_pass_case(
        dev, dtype, G, "ls", seed=3, p=622 if case == "ragged_tail" else None,
        zero_weight=case == "zero_weight", none_active=case == "no_active")
    sk, _, mk = _hold_group_pass(prob, st, lam0, n_scale, False, G)
    assert torch.equal(torch.where(prob.valid, sk.beta, 0.0), sk.beta)
    if case == "no_active":
        assert torch.equal(sk.beta, st.beta) and torch.equal(sk.r, st.r)
        assert float(mk) == 0.0
    if case == "zero_weight":
        assert float(prob.lamw[0, 1]) == 0.0


def test_polish_group_lasso_on_the_card(dev):
    """The group polish on the card: K5 f64 certifies, kkt_rel <= 1e-7, the
    certificate recomputed on the card and on the CPU agree, and the CPU
    polish from the same start reaches the same β."""
    from coordinatedescent_jl_tpu_torch import (group_lasso,
                                                group_lasso_kkt_compensated,
                                                polish_group_lasso)

    X, y, lam = _group_data(dev, 1500, 4000, 8, 8, seed=3)
    sol = group_lasso(X, y, lam, 8, options=CDOptions(opt_tol=1e-6,
                                                      randomize=False))
    n5 = gradient_sweep.LAUNCHES_F64
    res = polish_group_lasso(X, y, sol.x, lam, 8)
    assert gradient_sweep.LAUNCHES_F64 > n5
    assert res.converged and res.kkt_rel <= 1e-7, (res.kkt_rel, res.rounds)
    assert res.beta.is_cuda and res.beta.dtype == torch.float64
    kg, n_exact = group_lasso_kkt_compensated(X, y, res.beta, lam, 8)
    kc, _ = group_lasso_kkt_compensated(X.cpu(), y.cpu(), res.beta.cpu(),
                                        lam, 8, device="cpu")
    assert kg <= 1.1e-7 and n_exact == 500
    assert abs(kg - kc) <= 1e-9 * kc + 1e-15
    rc = polish_group_lasso(X.cpu(), y.cpu(), sol.x.cpu(), lam, 8,
                            device="cpu")
    torch.testing.assert_close(res.beta.cpu(), rc.beta, atol=1e-7, rtol=0)


def test_refit_lasso_path_min_norm_on_the_card(dev):
    """A rank-deficient support on the card (column 1 copied into column
    2, both in the support): the minimum-norm solution, as numpy gives it."""
    from coordinatedescent_jl_tpu_torch import LassoPath, refit_lasso_path

    rng = np.random.default_rng(12)
    Xn = rng.standard_normal((400, 12))
    Xn[:, 2] = Xn[:, 1]
    yn = (Xn[:, :4] @ np.array([1.0, -0.5, 0.25, 2.0])
          + 0.1 * rng.standard_normal(400))
    beta = np.zeros((1, 12))
    beta[0, [0, 1, 2, 3, 7]] = 1.0
    X = torch.as_tensor(Xn, dtype=torch.float32, device=dev)
    y = torch.as_tensor(yn, dtype=torch.float32, device=dev)
    out = refit_lasso_path(LassoPath(torch.tensor([0.1]),
                                     torch.as_tensor(beta)), X, y)
    coef = out[(0, 1, 2, 3, 7)]
    assert coef.is_cuda
    X32 = Xn.astype(np.float32).astype(np.float64)
    ref = np.linalg.lstsq(X32[:, [0, 1, 2, 3, 7]],
                          yn.astype(np.float32).astype(np.float64),
                          rcond=None)[0]
    np.testing.assert_allclose(coef.cpu().numpy(), ref, atol=1e-4)
    assert abs(float(coef[1] - coef[2])) < 1e-4


def test_symmetric_solve_on_the_card(dev):
    """Covariance thresholding through the packed quadratic loss on the
    card: the closed form (diagonal kept, soft(S, λ) off it) within 1e-5 in
    float32, and an exactly symmetric result."""
    from coordinatedescent_jl_tpu_torch import (ProxL1, QuadraticLoss,
                                                sym_indices, sym_pack,
                                                symmetric_coordinate_descent)

    p, lam = 24, 0.15
    A = np.random.default_rng(1).standard_normal((p, 40))
    S = A @ A.T / 40.0
    ij = sym_indices(p).numpy()
    off = (ij[:, 0] != ij[:, 1]).astype(np.float64)
    d = 1.0 + off
    s = sym_pack(torch.as_tensor(S)).numpy()
    f32 = dict(dtype=torch.float32, device=dev)
    M, _ = symmetric_coordinate_descent(
        torch.zeros((p, p), **f32),
        QuadraticLoss(torch.as_tensor(np.diag(d), **f32),
                      torch.as_tensor(-(d * s), **f32)),
        ProxL1(lam, torch.as_tensor(2.0 * off, **f32)),
        CDOptions(opt_tol=1e-7, randomize=False))
    assert M.is_cuda and torch.equal(M, M.T)
    want = np.sign(S) * np.maximum(np.abs(S) - lam, 0.0)
    np.fill_diagonal(want, np.diag(S))
    np.testing.assert_allclose(M.cpu().numpy(), want, atol=1e-5)


def _vc_point(dev, n=500, p=50, z0=0.5):
    """One grid point of the varying-coefficient scan at bench.py's shape
    (degree 1, 100 expanded columns in one block of 128, f32, the default
    options), built as the scan builds it, and a state at 0.9 of the
    point's solution."""
    from coordinatedescent_jl_tpu_torch import (
        GaussianKernel, ProxL1, WeightedLSLoss, coordinate_descent, evaluate,
        expand_X, std_X)
    from coordinatedescent_jl_tpu_torch.profile_paths import vc_bench_problem

    vp = vc_bench_problem(dev, n=n, p=p, g=10)
    w = evaluate(GaussianKernel(vp.h), vp.z, z0)
    eX = expand_X(vp.X, vp.z, z0, 1)
    lamw = std_X(eX, w)
    opts = CDOptions()
    prob = block_cd.build_blocked("wls", opts, lamw, X=eX, y=vp.y, w=w)
    beta, _ = coordinate_descent(torch.zeros(2 * p, device=dev),
                                 WeightedLSLoss(vp.y, eX, w),
                                 ProxL1(vp.lam0, lamw), opts)
    st = block_cd._init_state("wls", prob, block_cd._to_blocked_beta(
        0.9 * beta, 128).contiguous(), None)
    return prob, st, vp.lam0


def test_vc_point_kernels_match_twins(dev):
    """K1's wls form (both inners), K5, K3 with the screen off and K4 at the
    varying-coefficient scan's one-block shape: n = 500 gives K1 its
    16-CTA plan of 32 rows, K5 3 row slices of one column tile, K3/K4 one
    CTA.  Masks exact, values to the f32 tolerance."""
    prob, st, lam0 = _vc_point(dev)
    assert prob.Kb is not None and tuple(prob.lamw.shape) == (1, 128)
    assert _k1_plan(dev, 500, 128, torch.float32).grid == 16
    one = torch.arange(1, device=dev)
    act = torch.ones(1, dtype=torch.bool, device=dev)
    for inner in ("ista", "exact"):
        args = (prob, st.beta, st.r, act, lam0, 500.0, one,
                torch.arange(128, device=dev))
        k0 = active_pass.LAUNCHES_KIND["wls"][0]
        bk, rk, mk, _ = active_pass.fused_active_pass(
            *args, kind="wls", inner=inner)
        assert active_pass.LAUNCHES_KIND["wls"][0] == k0 + 1
        bp, rp, mp, _ = active_pass.fused_active_pass_plain(
            *args, kind="wls", inner=inner)
        torch.testing.assert_close(bk, bp, atol=1e-4, rtol=0)
        torch.testing.assert_close(mk, mp, atol=1e-4, rtol=0)
        torch.testing.assert_close(rk, rp, atol=1e-3, rtol=0)
    ck = gradient_sweep.fused_gradient_sweep(prob.Xwb, st.r)
    cp = gradient_sweep.fused_gradient_sweep_plain(prob.Xwb, st.r)
    torch.testing.assert_close(ck, cp, atol=1e-5 * float(cp.abs().max()),
                               rtol=0)
    scal = block_cd._check_scalars(lam0, 500.0, torch.dot(st.r, st.r),
                                   torch.zeros((), device=dev), 1e-7)
    validf = prob.valid.float()
    for drift in (0.0, 1e-3):
        a_args = (cp, st.beta, torch.full((1,), drift, device=dev),
                  prob.adiag, prob.lamw, validf, prob.xwnorm, scal)
        outk = check.check_phase_a(*a_args, screen=False)
        outp = check.check_phase_a_plain(*a_args, screen=False)
        for i in (0, 1, 2, 5):
            assert torch.equal(outk[i], outp[i]), i
        for i in (3, 4):
            torch.testing.assert_close(outk[i], outp[i], rtol=1e-5,
                                       atol=1e-7)
        b_args = (cp, st.beta, outp[3], outp[1], outp[2], prob.adiag,
                  prob.lamw, validf, prob.xwnorm, scal)
        outk = check.check_phase_b(*b_args)
        outp = check.check_phase_b_plain(*b_args)
        assert torch.equal(outk[1], outp[1])
        torch.testing.assert_close(outk[0], outp[0], rtol=1e-5, atol=1e-7)


def test_locpoly_fallback_on_the_card(dev):
    """``locpoly``'s fallback on the card: a zero-mass point (singular
    normal equations: ``solve_ex`` gives non-finite numbers, no exception)
    is the minimum-norm solution, all zeros; float64 agrees with the CPU
    at 1e-10; a forced ill-conditioned point is the SVD solve's."""
    from coordinatedescent_jl_tpu_torch import EpanechnikovKernel, locpoly

    rng = np.random.default_rng(3)
    n, p = 120, 4
    z = rng.uniform(0, 1, n)
    X = rng.standard_normal((n, p))
    y = X[:, 0] * np.sin(2 * np.pi * z) + 0.1 * rng.standard_normal(n)
    zg = np.array([0.5, 50.0])
    kern = EpanechnikovKernel(0.1)
    out = locpoly(X, z, y, zg, 1, kern)
    assert out.is_cuda and bool(torch.isfinite(out).all())
    assert bool(torch.all(out[:, 1] == 0))
    torch.testing.assert_close(out.cpu(), locpoly(X, z, y, zg, 1, kern,
                                                  device="cpu"),
                               atol=1e-10, rtol=0)
    out32 = locpoly(X.astype(np.float32), z, y, zg, 1, kern)
    assert bool(torch.isfinite(out32).all())
    assert bool(torch.all(out32[:, 1] == 0))
    torch.testing.assert_close(out32[:, 0].double().cpu(), out[:, 0].cpu(),
                               atol=1e-4, rtol=0)


def test_locpolyl1_on_the_card(dev):
    """The scan with the kernels (K1 wls, K3, K4, K5; never K2) against the
    plain scan, and the batched grid certified, at a small f32 shape:
    no coordinate above 1e-4 in one support and not the other."""
    from coordinatedescent_jl_tpu_torch import GaussianKernel, locpolyl1
    from coordinatedescent_jl_tpu_torch.profile_paths import (
        launch_counts, reset_launch_counts, vc_bench_problem)

    vp = vc_bench_problem(dev, n=200, p=20, g=40)
    kern = GaussianKernel(vp.h)
    reset_launch_counts()
    ok_, rk = locpolyl1(vp.X, vp.z, vp.y, vp.zgrid, 1, kern, vp.lam0,
                        grid_batch=0)
    c = launch_counts()
    assert min(c["K1wls"], c["K3"], c["K4"], c["K5"]) > 0 and c["K2"] == 0
    op, rp = locpolyl1(vp.X, vp.z, vp.y, vp.zgrid, 1, kern, vp.lam0,
                       options=CDOptions(use_pallas=False), grid_batch=0)

    def mismatch(a, b):
        differ = (a != 0) != (b != 0)
        return int((differ & (torch.maximum(a.abs(), b.abs()) > 1e-4)).sum())

    assert mismatch(ok_, op) == 0
    st = {}
    ob, rb = locpolyl1(vp.X, vp.z, vp.y, vp.zgrid, 1, kern, vp.lam0,
                       grid_batch=128, stats=st)
    assert st["used_batched"] and st["batched_certified"]
    assert mismatch(ob, ok_) == 0
    assert bool(torch.isfinite(rb).all()) and ob.is_cuda


def _resume_problem(dev, n=500, p=2048, s=12, seed=21):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    beta[rng.choice(p, s, replace=False)] = rng.standard_normal(s)
    y = X @ beta + 0.3 * rng.standard_normal(n)
    return (torch.as_tensor(X, dtype=torch.float32, device=dev),
            torch.as_tensor(y, dtype=torch.float32, device=dev))


def test_resume_bitwise_with_compaction_on_the_card(dev, tmp_path):
    """An interrupted and resumed randomized path with compaction and the
    secant start is bit for bit the uninterrupted one on the card: every
    kernel adds in a fixed order."""
    from coordinatedescent_jl_tpu_torch import (
        lasso_path_resumable, load_checkpoint, save_checkpoint)
    from coordinatedescent_jl_tpu_torch.profile_paths import (
        launch_counts, reset_launch_counts)

    X, y = _resume_problem(dev)
    lmax = float(torch.max(torch.abs(y @ X)) / X.shape[0])
    lams = lmax * np.logspace(-0.3, -1.3, 12)
    opts = CDOptions(block_size=64, compact=True, compact_size=256,
                     extrapolate=True, randomize=True, opt_tol=1e-6)
    f1, f2 = str(tmp_path / "full.npz"), str(tmp_path / "inter.npz")
    reset_launch_counts()
    full = lasso_path_resumable(X, y, lams, f1, options=opts, seed=5)
    assert launch_counts()["K1"] and launch_counts()["K3"]
    lasso_path_resumable(X, y, lams[:5], f2, options=opts, seed=5)
    ck = load_checkpoint(f2)
    save_checkpoint(f2, ck._replace(lam_path=np.asarray(lams, np.float32)))
    res = lasso_path_resumable(X, y, lams, f2, options=opts, seed=5)
    assert res.beta_path.device == X.device
    assert torch.equal(res.beta_path, full.beta_path)
    c1, c2 = load_checkpoint(f1), load_checkpoint(f2)
    assert c1.ws_idx.shape == (256,)
    for fld in ("beta_path", "beta_warm", "residuals", "key", "c", "drift",
                "active", "ws_idx", "ws_ok", "beta_prev", "lam_k",
                "lam_km1"):
        assert np.array_equal(getattr(c1, fld), getattr(c2, fld)), fld


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("warm", [True, False])
def test_count_x_kernels_match_plain_on_the_card(dev, dtype, warm):
    """The design-read count of a solve with the kernels equals the plain
    run's (the same refresh decisions: the fused check's masks are the
    plain formulas bit for bit), and count_x changes no bit of the
    kernels' solve.  K1 takes its exact inner: the plain path's active
    pass is the exact scan (as in the JAX package), and K1's FISTA inner,
    float32's default, is another algorithm with other refreshes."""
    X, y = _resume_problem(dev, seed=22)
    X, y = X.to(dtype), y.to(dtype)
    lam = 0.1 * float(torch.max(torch.abs(y @ X)) / X.shape[0])
    opts = CDOptions(block_size=64, compact=True, compact_size=256,
                     randomize=False, opt_tol=1e-6, warm_start=warm,
                     num_steps=5, inner="exact")

    def solve(o, count):
        prob = block_cd.build_blocked("ls", o, torch.ones(X.shape[1],
                                                          dtype=dtype,
                                                          device=dev),
                                      X=X, y=y)
        return block_cd.solve_blocked(
            "ls", o, prob, lam, torch.zeros_like(prob.lamw),
            torch.Generator().manual_seed(0), count_x=count)

    st_k, xe_k = solve(opts, True)
    st_p, xe_p = solve(opts.replace(use_pallas=False), True)
    assert xe_k == xe_p and st_k.it == st_p.it
    assert torch.equal(solve(opts, False).beta, st_k.beta)


def test_debug_nans_catches_kernel_nans(dev):
    """A NaN in r comes out of K5 and out of K1 as a FloatingPointError
    while debug_nans is on; off, the same calls return NaN."""
    from coordinatedescent_jl_tpu_torch import debug_nans
    from coordinatedescent_jl_tpu_torch.kernels import _build

    prob, st = _problem(dev, torch.float32)
    nb, B = prob.lamw.shape
    r = st.r.clone()
    r[5] = float("nan")
    order = (torch.arange(nb, device=dev), torch.arange(B, device=dev))
    calls = (lambda: gradient_sweep.fused_gradient_sweep(prob.Xwb, r),
             lambda: active_pass.fused_active_pass(
                 prob, st.beta, r, torch.ones(nb, dtype=torch.bool,
                                              device=dev), 0.05,
                 float(r.shape[0]), *order, inner="ista"))
    for call in calls:
        with debug_nans(), pytest.raises(FloatingPointError):
            call()
        assert not _build.NAN_CHECK
    assert torch.isnan(calls[0]()).any()
    assert torch.isnan(calls[1]()[1]).any()      # the residual K1 returns


# ---- the multi-device tiers on the card (a world of one rank, NCCL) ------


@pytest.fixture
def nccl_one(dev):
    """A world of one rank on NCCL (a ``HashStore``), torn down after."""
    import torch.distributed as dist

    from coordinatedescent_jl_tpu_torch.parallel import distributed as pd

    pd.initialize_distributed(backend="nccl", store=dist.HashStore(),
                              num_processes=1, process_id=0, timeout=120)
    try:
        yield pd
    finally:
        dist.destroy_process_group()


def test_lasso_sharded_world_of_one_on_the_card(dev, nccl_one):
    """``lasso_sharded`` on a world of one: the single-device ``lasso``'s
    support, and the shard launches K1 (its passes and compaction rounds),
    K3/K4 (its check, screen off) and K5."""
    from coordinatedescent_jl_tpu_torch.parallel import lasso_sharded
    from coordinatedescent_jl_tpu_torch.profile_paths import (
        reset_launch_counts)

    X, y, lam_max = _path_problem(dev, n=400, p=3000)
    opts = CDOptions(block_size=128, opt_tol=1e-6, randomize=False)
    ref = lasso(X, y, 0.1 * lam_max, options=opts)
    reset_launch_counts()
    sol = lasso_sharded(X, y, 0.1 * lam_max, nccl_one.feature_mesh(),
                        options=opts)
    n = _launches()
    assert n["K1"] > 0 and n["K3"] > 0 and n["K4"] > 0 and n["K5"] > 0, n
    assert sol.x.is_cuda and sol.x.shape == ref.x.shape
    big = torch.maximum(sol.x.abs(), ref.x.abs()) > 1e-4
    assert torch.equal((sol.x != 0) & big, (ref.x != 0) & big)
    assert float((sol.x - ref.x).abs().max()) < 1e-4


def test_sharded_check_kernels_match_plain_check(dev, nccl_one):
    """The shard's full check on the card runs K3 (screen off) and K4 and
    gives the plain check's masks and certificate."""
    from coordinatedescent_jl_tpu_torch.parallel.sharded_cd import (
        _sharded_full_check, make_shard)
    from coordinatedescent_jl_tpu_torch.profile_paths import (
        reset_launch_counts)

    prob, st = _problem(dev, torch.float32)
    sh = make_shard(nccl_one.feature_mesh(), "feature")
    n_scale = float(prob.y.shape[0])
    lam0 = 0.3 * float(torch.max(torch.abs(prob.Xwb.transpose(1, 2)
                                            @ prob.y[None, :, None]))) / n_scale
    # a mid-solve state: fresh c on half of the blocks, drift on the rest
    c = block_cd._full_gradient_c("ls", prob, st.r, False)
    nb = prob.lamw.shape[0]
    drift = torch.where(torch.arange(nb, device=dev) % 2 == 0,
                        torch.zeros(nb, device=dev),
                        torch.full((nb,), 0.05, device=dev))
    st = st._replace(c=c, drift=drift)
    opts = CDOptions(block_size=prob.lamw.shape[1], opt_tol=1e-6)
    reset_launch_counts()
    stk, mk = _sharded_full_check("ls", prob, st, lam0, n_scale, 1e-6, sh,
                                  opts)
    n = _launches()
    assert n["K3"] == 1 and n["K4"] <= 1, n
    stp, mp = block_cd._full_check("ls", prob, st, lam0, n_scale, 1e-6,
                                   opts.replace(use_pallas=False,
                                                screen=False))
    assert torch.equal(stk.active, stp.active)
    assert torch.equal(stk.drift, stp.drift)
    assert abs(float(mk) - float(mp)) <= 1e-5 * max(1.0, float(mp))
    torch.testing.assert_close(stk.c, stp.c, rtol=1e-5, atol=1e-4)


def test_row_sharded_gradient_launches_k5(dev, nccl_one):
    """``lasso_row_sharded``'s local gradient is K5 (then one all_reduce);
    the solution has the single-device ``lasso``'s support."""
    from coordinatedescent_jl_tpu_torch.parallel import lasso_row_sharded
    from coordinatedescent_jl_tpu_torch.parallel.row_sharded import (
        _Axes, _row_full_c)
    from coordinatedescent_jl_tpu_torch.profile_paths import (
        reset_launch_counts)

    X, y, lam_max = _path_problem(dev, n=400, p=700)
    opts = CDOptions(block_size=128, opt_tol=1e-6, randomize=False)
    ref = lasso(X, y, 0.1 * lam_max, options=opts)
    mesh = nccl_one.obs_mesh()
    reset_launch_counts()
    sol = lasso_row_sharded(X, y, 0.1 * lam_max, mesh, options=opts)
    assert _launches()["K5"] > 0
    big = torch.maximum(sol.x.abs(), ref.x.abs()) > 1e-4
    assert torch.equal((sol.x != 0) & big, (ref.x != 0) & big)
    # the local gradient against the plain product
    prob = block_cd.build_blocked("ls", opts, torch.ones(700, device=dev),
                                  X=X, y=y)
    ax = _Axes(mesh.get_group("obs"), None, 1, True)
    reset_launch_counts()
    c = _row_full_c(prob, y, ax)
    assert _launches()["K5"] == 1
    torch.testing.assert_close(
        c, torch.einsum("bnk,n->bk", prob.Xwb, y), rtol=1e-5, atol=1e-3)


def test_sharded_design_exchange_two_gloo_ranks_on_the_card(dev, tmp_path):
    """Two Gloo ranks on the card, each with its block of the plan
    (``load_sharded_design``: 20 columns) where the solver owns 24: the
    four columns rank 0 lacks come from rank 1 (point to point, staged
    through the host), and ``lasso_sharded`` is bit for bit its run on
    the global design, the same in both ranks."""
    from coordinatedescent_jl_tpu_torch.parallel.distributed import World
    from torch_rank_calls import Call, run_calls

    n, p = 200, 40
    rng = np.random.default_rng(5)
    X = rng.standard_normal((n, p)).astype(np.float32)
    y = (X[:, :3] @ np.array([1.0, -2.0, 0.5], np.float32)
         + 0.3 * rng.standard_normal(n).astype(np.float32))
    f = str(tmp_path / "X.bin")
    X.tofile(f)
    lam = 0.1 * float(np.abs(X.T @ y).max()) / n
    opts = CDOptions(block_size=8, opt_tol=1e-6, randomize=False)
    mesh = ((2,), ("feature",))
    calls = [("parallel.lasso_sharded", mesh,
              (Call("parallel.distributed.load_sharded_design", (f, n, p)),
               y, lam), {"options": opts}),
             ("parallel.lasso_sharded", mesh, (X, y, lam),
              {"options": opts})]
    ranks = World(run_calls, 2, (calls, "cuda:0"), backend="gloo",
                  timeout=300).wait()
    for r in ranks:
        assert not any("_error" in c for c in r), r
        assert np.array_equal(r[0]["x"], r[1]["x"])
        assert np.array_equal(r[0]["x"], ranks[0][0]["x"])
    assert np.count_nonzero(ranks[0][0]["x"]) > 0


def test_multiproc_bench_card_mode_world_of_one(dev):
    """``multiproc_bench``'s default mode: one NCCL rank a card; a world of
    one at a small shape solves on the card and counts its collectives."""
    from coordinatedescent_jl_tpu_torch import multiproc_bench

    out = multiproc_bench.run(n=300, p=1024, s=5, worlds=(1,), reps=1,
                              timeout=300)
    assert out["device"] == "cuda" and out["curve"]["1"]["nnz"] > 0
    assert "efficiency" not in out
    assert out["curve"]["1"]["collectives"]["all_reduce"]["calls"] > 0
