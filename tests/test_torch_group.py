"""PyTorch port: the group iterate — ``group_lasso``,
``group_coordinate_descent`` (ls, wls, sqrt), the block visit, the f64
group certificate and ``polish_group_lasso`` — against the JAX package.

Plain twins on the CPU, float64, ``randomize=False`` (JAX and torch visit
orders cannot match when randomized): with identical trajectories the two
packages agree to rounding, so β is held to 1e-9 and the group support
must be the same.  Shapes follow tests/test_group.py and
tests/test_diagnostics.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import coordinatedescent_jl_tpu as cd  # noqa: E402
from coordinatedescent_jl_tpu.ops import group_cd as jgroup  # noqa: E402
import coordinatedescent_jl_tpu_torch as tcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.ops import group_cd as tgroup  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils.convert import (  # noqa: E402
    group_problem_from_jax, group_state_from_jax, options_from_jax)


def _gen(n, p, G, s_groups, seed=0, noise=0.5):
    """tests/test_group.py's generator: ``s_groups`` planted groups."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    for g in rng.choice(p // G, s_groups, replace=False):
        beta[g * G:(g + 1) * G] = rng.standard_normal(G)
    return X, X @ beta + noise * rng.standard_normal(n)


def _groups(x, G):
    """The set of nonzero groups of a coefficient vector."""
    x = np.pad(np.asarray(x), (0, -len(x) % G)).reshape(-1, G)
    return set(np.nonzero(np.any(x != 0, axis=1))[0].tolist())


def _same(xt, xj, G, atol=1e-9):
    xt, xj = np.asarray(xt), np.asarray(xj)
    np.testing.assert_allclose(xt, xj, atol=atol)
    assert _groups(xt, G) == _groups(xj, G)
    assert _groups(xt, G)


def _both_group_lasso(X, y, lam, G, opts, weights=None):
    sj = cd.group_lasso(X, y, lam, G, options=opts,
                        weights=None if weights is None
                        else jnp.asarray(weights))
    st = tcd.group_lasso(X, y, lam, G, options=options_from_jax(opts),
                         weights=weights, device="cpu")
    return st, sj


OPTS = cd.CDOptions(opt_tol=1e-10, randomize=False)


@pytest.mark.parametrize("G", [4, 8])
def test_group_lasso_matches_jax(G):
    X, y = _gen(150, 64, G, 3)
    st, sj = _both_group_lasso(X, y, 0.08, G, OPTS)
    _same(st.x, sj.x, G)
    np.testing.assert_allclose(st.residuals.numpy(), np.asarray(sj.residuals),
                               atol=1e-9)
    np.testing.assert_allclose(float(st.sigma), float(sj.sigma), rtol=1e-9)
    assert st.penalty.group_size == G


def test_group_lasso_weighted_matches_jax():
    X, y = _gen(120, 48, 6, 3, seed=3)
    w = 0.5 + np.random.default_rng(9).random(48 // 6)
    st, sj = _both_group_lasso(X, y, 0.1, 6, OPTS, weights=w)
    _same(st.x, sj.x, 6)


def test_group_wls_matches_jax():
    """The weighted least-squares loss: ``Xwb`` a second design, Grams
    ``Xw'X``."""
    X, y = _gen(140, 48, 4, 3, seed=11)
    rw = 0.2 + np.random.default_rng(13).random(140)
    bj, rj = cd.group_coordinate_descent(
        jnp.zeros(48), cd.WeightedLSLoss(jnp.asarray(y), jnp.asarray(X),
                                         jnp.asarray(rw)),
        cd.ProxL1Group(0.08, 4), OPTS)
    bt, rt = tcd.group_coordinate_descent(
        torch.zeros(48, dtype=torch.float64),
        tcd.WeightedLSLoss(torch.as_tensor(y), torch.as_tensor(X),
                           torch.as_tensor(rw)),
        tcd.ProxL1Group(0.08, 4), options_from_jax(OPTS), device="cpu")
    _same(bt, bj, 4)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-9)


@pytest.mark.parametrize("G", [4, 6])
def test_group_sqrt_matches_jax(G):
    """The sqrt loss by MM rounds (``n_scale := ‖r‖``), cold and then
    warm-started with per-group weights."""
    X, y = _gen(150, 48, G, 3, seed=7)
    lam = 1.1 * np.sqrt(2 * np.log(48))
    opts = cd.CDOptions(opt_tol=1e-11, randomize=False)
    ng = 48 // G
    wg = 0.5 + np.arange(ng) / ng
    jloss = cd.SqrtLassoLoss(jnp.asarray(y), jnp.asarray(X))
    tloss = tcd.SqrtLassoLoss(torch.as_tensor(y), torch.as_tensor(X))
    bj, rj = cd.group_coordinate_descent(jnp.zeros(48), jloss,
                                         cd.ProxL1Group(lam, G), opts)
    bt, rt = tcd.group_coordinate_descent(
        torch.zeros(48, dtype=torch.float64), tloss, tcd.ProxL1Group(lam, G),
        options_from_jax(opts), device="cpu")
    _same(bt, bj, G)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-9)
    bjw, _ = cd.group_coordinate_descent(
        bj, jloss, cd.ProxL1Group(lam, G, jnp.asarray(wg)), opts)
    btw, _ = tcd.group_coordinate_descent(
        bt, tloss, tcd.ProxL1Group(lam, G, torch.as_tensor(wg)),
        options_from_jax(opts), device="cpu")
    _same(btw, bjw, G)


def test_group_ragged_tail_matches_jax():
    """p = 27, G = 5: a ragged tail group, padded to the block."""
    X, y = _gen(90, 30, 5, 2, seed=13)
    st, sj = _both_group_lasso(X[:, :27], y, 0.1, 5, OPTS)
    assert st.x.shape == (27,)
    _same(st.x, sj.x, 5)


def test_group_size_one_matches_lasso():
    """G = 1: ‖β_g‖₂ = |β_j|, the port's group engine gives the port's
    Lasso."""
    X, y = _gen(100, 32, 1, 6, seed=7)
    opts = tcd.CDOptions(opt_tol=1e-10, randomize=False)
    g1 = tcd.group_lasso(X, y, 0.1, 1, options=opts, device="cpu")
    l1 = tcd.lasso(X, y, 0.1, options=opts, device="cpu")
    np.testing.assert_allclose(g1.x.numpy(), l1.x.numpy(), atol=1e-7)


def test_group_cold_start_matches_jax():
    """``warm_start=False``: λ-continuation from the group λmax (K5's twin
    sweeps the zero start), then the same solution as the warm solve."""
    X, y = _gen(100, 40, 4, 3, seed=8)
    opts = OPTS.replace(warm_start=False, num_steps=20)
    st, sj = _both_group_lasso(X, y, 0.05, 4, opts)
    _same(st.x, sj.x, 4)
    warm = tcd.group_lasso(X, y, 0.05, 4, options=options_from_jax(OPTS),
                           device="cpu")
    np.testing.assert_allclose(st.x.numpy(), warm.x.numpy(), atol=1e-6)


def test_group_wider_than_a_block_matches_jax():
    """G = 130 > 128: one group per block, B = G."""
    assert tgroup._block_width(130) == 130
    X, y = _gen(200, 260, 130, 1, seed=3)
    st, sj = _both_group_lasso(X, y, 0.5, 130, OPTS)
    _same(st.x, sj.x, 130)


def test_block_visit_matches_jax():
    """One visit with k = 3 groups of G = 4 in the block, a weighted Gram
    ``Xw'X`` (not symmetric, not block-diagonal: groups 0 and 1 are
    coupled) and a group the FISTA step leaves nonzero that the solo-zero
    snap zeroes.  A transposed ``own`` term in the snap would show here."""
    k, G = 3, 4
    rng = np.random.default_rng(0)
    X = rng.standard_normal((40, k * G))
    X[:, 4:8] += 0.8 * X[:, 0:4]
    w = 0.3 + rng.random(40)
    K = (X * w[:, None]).T @ X
    c0 = (X * w[:, None]).T @ (3.0 * rng.standard_normal(40))
    beta0 = 0.3 * rng.standard_normal(k * G)
    L = float(np.max(np.sum(np.abs(K), axis=1)))
    zn = np.linalg.norm((beta0 + c0 / L).reshape(k, G), axis=1)
    thr = zn * np.array([0.2, 0.95, 0.02])
    for iters in (1, 2, 16):
        dj, mj = jgroup._block_visit(jnp.asarray(K), jnp.asarray(c0),
                                     jnp.asarray(beta0), jnp.asarray(L),
                                     jnp.asarray(thr), k, G, iters)
        dt, mt = tgroup._block_visit(
            torch.tensor(K), torch.tensor(c0), torch.tensor(beta0),
            torch.tensor(L, dtype=torch.float64), torch.tensor(thr), k, G,
            tgroup._fista_coefs(iters, torch.float64))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-12)
        np.testing.assert_allclose(float(mt), float(mj), rtol=1e-12)
        # group 1: the first prox step keeps it (‖z_1‖ > thr_1), the snap
        # zeroes it; groups 0 and 2 stay nonzero
        d = dt.numpy().reshape(k, G)
        assert np.all(d[1] == 0) and np.all(d[[0, 2]] != 0)
    assert zn[1] > thr[1]


def test_group_passes_match_jax_on_converted_state():
    """The full check (K5's twin) and one active pass from the same mid-solve
    state, the JAX records converted with ``group_problem_from_jax`` /
    ``group_state_from_jax``."""
    X, y = _gen(80, 40, 4, 3, seed=5)
    w = 0.5 + np.random.default_rng(6).random(5)
    G, lam = 4, 0.06
    jp = jgroup._build_group_problem(jnp.asarray(X), jnp.asarray(y),
                                     jnp.asarray(np.r_[w, w][:10]), G)
    beta = np.zeros(40)
    beta[4:12] = 0.2
    b_g = jnp.asarray(np.pad(beta, (0, 128 - 40)).reshape(1, 128))
    js = jgroup.GroupState(beta=b_g, r=jp.y - jnp.einsum("bnk,bk->n", jp.Xb,
                                                         b_g),
                           active=jnp.asarray([True]),
                           key=jax.random.PRNGKey(0),
                           it=jnp.asarray(0), conv=jnp.asarray(True),
                           done=jnp.asarray(False))
    tp = group_problem_from_jax(jp)
    ts = group_state_from_jax(js)
    assert tp.Xwb is tp.Xb
    tbuilt = tgroup._build_group_problem(torch.as_tensor(X),
                                         torch.as_tensor(y),
                                         torch.as_tensor(np.r_[w, w][:10]), G)
    for a, b in zip(tbuilt, tp):
        np.testing.assert_allclose(a.double().numpy(), b.double().numpy(),
                                   rtol=1e-12, atol=1e-12)
    jc, jm = jgroup._group_full_check(jp, js, lam, 80.0, 1e-9)
    tc, tm = tgroup._group_full_check(tp, ts, lam, 80.0, 1e-9, False)
    np.testing.assert_allclose(float(tm), float(jm), rtol=1e-12)
    assert np.array_equal(tc.active.numpy(), np.asarray(jc.active))
    ja, jam = jgroup._group_active_pass(jp, js, lam, 80.0, False, 16)
    ta, tam = tgroup._group_active_pass(
        tp, ts, lam, 80.0, False, tgroup._fista_coefs(16, torch.float64))
    np.testing.assert_allclose(ta.beta.numpy(), np.asarray(ja.beta),
                               atol=1e-12)
    np.testing.assert_allclose(ta.r.numpy(), np.asarray(ja.r), atol=1e-12)
    np.testing.assert_allclose(float(tam), float(jam), rtol=1e-12)


def test_fista_coefs_in_the_dtype():
    """The momentum coefficients are the JAX engine's, computed in the
    solve's dtype (float32 ones differ from Python doubles)."""
    c32 = tgroup._fista_coefs(16, torch.float32)
    c64 = tgroup._fista_coefs(16, torch.float64)
    assert c32[0] == c64[0] == 0.0
    assert all(float(np.float32(c)) == c for c in c32)
    assert c32 != c64
    np.testing.assert_allclose(c32, c64, rtol=1e-6)


def test_group_f32_matches_f64_support():
    """float32 at the default opt_tol 1e-7 (below the dtype's step floor):
    the noise floor of the full check ends the solve with the f64 group
    support (tests/test_group.py's f32 case)."""
    X, y = _gen(200, 64, 8, 3, seed=4)
    opts = tcd.CDOptions(opt_tol=1e-7, randomize=False)
    s32 = tcd.group_lasso(X.astype(np.float32), y.astype(np.float32), 0.08,
                          8, options=opts, device="cpu")
    s64 = tcd.group_lasso(X, y, 0.08, 8, options=opts, device="cpu")
    assert s32.x.dtype == torch.float32
    assert _groups(s32.x.numpy(), 8) == _groups(s64.x.numpy(), 8)
    np.testing.assert_allclose(s32.x.numpy(), s64.x.numpy(), atol=5e-5)


def test_group_soft_threshold_matches_jax():
    from coordinatedescent_jl_tpu.ops.prox import group_soft_threshold as jgst

    v = np.random.default_rng(2).standard_normal((5, 4))
    v[3] = 0.0
    t = np.array([0.1, 3.0, 0.5, 1.0, 0.2])[:, None]
    np.testing.assert_allclose(
        tcd.group_soft_threshold(torch.tensor(v), torch.tensor(t)).numpy(),
        np.asarray(jgst(jnp.asarray(v), jnp.asarray(t))), atol=1e-15)


def test_group_errors_and_device_rule(monkeypatch):
    X, y = _gen(30, 12, 4, 1)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    b0 = torch.zeros(12, dtype=torch.float64)
    with pytest.raises(TypeError):
        tcd.group_coordinate_descent(b0, tcd.QuadraticLoss(Xt.T @ Xt, yt @ Xt),
                                     tcd.ProxL1Group(0.1, 4), device="cpu")
    with pytest.raises(ValueError):
        tcd.group_lasso(X, y, 0.1, 0, device="cpu")
    with pytest.raises(ValueError):
        tcd.group_lasso(X, y, 0.1, 4, weights=np.ones(4), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tcd.group_lasso(X, y, 0.1, 4),
                 lambda: tcd.group_coordinate_descent(
                     b0, tcd.LeastSquaresLoss(yt, Xt),
                     tcd.ProxL1Group(0.1, 4)),
                 lambda: tcd.group_lasso_kkt_compensated(X, y, np.zeros(12),
                                                         0.1, 4),
                 lambda: tcd.polish_group_lasso(X, y, np.zeros(12), 0.1, 4)):
        with pytest.raises(RuntimeError):
            call()


def _diag_gen(n, p, s, seed):
    """tests/test_diagnostics.py's generator (float32, first ``s`` columns
    carry the signal)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    beta = np.zeros(p, np.float32)
    beta[:s] = rng.standard_normal(s)
    return X, (X @ beta + 0.1 * rng.standard_normal(n)).astype(np.float32)


def test_group_kkt_compensated_matches_jax():
    """The certificate of an f32 solve, unweighted and weighted: the port's
    full f64 sweep against the JAX hybrid (both exact where the roll-up
    reads), relative 1e-9; ``col_chunk`` and ``cap`` are taken and
    ignored."""
    X, y = _diag_gen(200, 203, 6, seed=29)
    G, lam = 8, 0.08
    sol = cd.group_lasso(jnp.asarray(X), jnp.asarray(y), lam, G)
    x0 = np.asarray(sol.x)
    wg = 0.5 + np.random.default_rng(3).random(-(-203 // G))
    for w in (None, wg):
        kj, _ = cd.group_lasso_kkt_compensated(X, y, x0, lam, G, w)
        kt, n_exact = tcd.group_lasso_kkt_compensated(X, y, x0, lam, G, w,
                                                      device="cpu")
        np.testing.assert_allclose(kt, kj, rtol=1e-9)
        assert kt > 1e-9 and n_exact == -(-203 // G)
        kc, _ = tcd.group_lasso_kkt_compensated(X, y, x0, lam, G, w,
                                                col_chunk=128, cap=64,
                                                device="cpu")
        assert kc == kt
    with pytest.raises(ValueError):
        tcd.group_lasso_kkt_compensated(X, y, x0, lam, G, cap=0,
                                        device="cpu")


@pytest.mark.parametrize("n,p,seed", [(300, 800, 23), (200, 203, 29)])
def test_polish_group_lasso_reaches_target(n, p, seed):
    """tests/test_diagnostics.py's two group cases (the second with a
    ragged tail group): from the port's f32 solve to a per-group relative
    KKT ≤ 1e-7, re-certified, and the same polished β as the JAX polish;
    from a zero start the same point."""
    X, y = _diag_gen(n, p, 10 if p == 800 else 6, seed)
    G = 8
    lam = 0.06 if p == 800 else 0.08
    sol = tcd.group_lasso(X, y, lam, G, device="cpu")
    assert sol.x.dtype == torch.float32
    res = tcd.polish_group_lasso(X, y, sol.x, lam, G, device="cpu")
    assert res.converged and res.kkt_rel <= 1e-7, (res.kkt_rel, res.rounds)
    assert res.beta.dtype == torch.float64 and res.beta.shape == (p,)
    kkt_chk, _ = tcd.group_lasso_kkt_compensated(X, y, res.beta, lam, G,
                                                 device="cpu")
    assert kkt_chk <= 1.1e-7
    rj = cd.polish_group_lasso(X, y, res.beta.numpy().astype(np.float32),
                               lam, G)
    assert rj.converged
    np.testing.assert_allclose(res.beta.numpy(), np.asarray(rj.beta),
                               atol=1e-8)
    if p == 800:
        res0 = tcd.polish_group_lasso(X, y, np.zeros(p), lam, G,
                                      col_chunk=256, device="cpu")
        assert res0.converged and res0.kkt_rel <= 1e-7
        np.testing.assert_allclose(res0.beta.numpy(), res.beta.numpy(),
                                   atol=1e-8)
