"""PyTorch port: the float64 certificate (``ops/compensated.py``) and the
active-set polish (``models/polish.py``) against the JAX package.

The JAX package certifies with its hybrid sweep ``grad_f64_certified``
(exact f64 where the certificate reads the gradient); the port uses the
full f64-accumulating sweep ``grad_f64``.  Both give the certificate
exact values, so the gaps, the working-set growth and the rounds agree.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import coordinatedescent_jl_tpu as cd  # noqa: E402
from coordinatedescent_jl_tpu.ops import compensated as jcomp  # noqa: E402
import coordinatedescent_jl_tpu_torch as tcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.kernels import (  # noqa: E402
    gradient_sweep as tgs)
from coordinatedescent_jl_tpu_torch.ops import (  # noqa: E402
    compensated as tcomp)


def _gen(n, p, s, seed, dtype=np.float32):
    """tests/test_diagnostics.py's generator: the first ``s`` columns carry
    the signal."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(dtype)
    beta = np.zeros(p, dtype)
    beta[:s] = rng.standard_normal(s)
    y = (X @ beta + 0.1 * rng.standard_normal(n)).astype(dtype)
    return X, y


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grad_f64_plain_matches_jax(dtype):
    """f64 accumulation over an f32 (or f64) design, p = 9000 spanning two
    column chunks of the twin, rtol 1e-12 (and 1e-12 of max|g| for the
    entries that cancel)."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((60, 9000)).astype(dtype)
    r = rng.standard_normal(60)
    with jax.enable_x64(True):
        ref = np.asarray(jcomp.grad_f64(jnp.asarray(X), jnp.asarray(r)))
    out = tgs.grad_f64_plain(torch.as_tensor(X), torch.as_tensor(r))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
    # the module-level entry point takes the twin for CPU tensors
    np.testing.assert_array_equal(
        tcomp.grad_f64(torch.as_tensor(X), torch.as_tensor(r)).numpy(),
        out.numpy())


def test_compensated_gap_matches_jax():
    X, y = _gen(200, 300, 8, seed=3)
    rng = np.random.default_rng(4)
    beta = np.zeros(300, np.float32)
    beta[rng.choice(300, 12, replace=False)] = rng.standard_normal(
        12).astype(np.float32)
    w = np.abs(rng.standard_normal(300)).astype(np.float32) + 0.5
    for weights in (None, w):
        with jax.enable_x64(True):
            gj, pj = cd.lasso_duality_gap_compensated(X, y, beta, 0.2,
                                                      weights)
        gt, pt = tcd.lasso_duality_gap_compensated(X, y, beta, 0.2, weights,
                                                   device="cpu")
        np.testing.assert_allclose(gt, gj, rtol=1e-9)
        np.testing.assert_allclose(pt, pj, rtol=1e-12)


def _polish_both(X, y, beta, lam, **kw):
    with jax.enable_x64(True):
        rj = cd.polish_lasso(X, y, beta, lam, **kw)
    rt = tcd.polish_lasso(X, y, beta, lam, device="cpu", **kw)
    return rj, rt


def _same_polish(rj, rt):
    assert rt.converged == rj.converged
    assert rt.rounds == rj.rounds
    assert rt.support_size == rj.support_size
    assert rt.beta.dtype == torch.float64
    np.testing.assert_allclose(rt.beta.numpy(), np.asarray(rj.beta),
                               atol=1e-9)


def test_polish_reaches_target_gap():
    """tests/test_diagnostics.py:203's problem: from a coarse (opt_tol 1e-5)
    f32 solve, both packages certify rel gap <= 1e-7 in the same rounds,
    unweighted and weighted."""
    X, y = _gen(300, 800, 10, seed=11)
    lam = 0.05 * float(np.max(np.abs(X.astype(np.float64).T
                                     @ y.astype(np.float64))) / 300)
    opts = cd.CDOptions(opt_tol=1e-5, randomize=False)
    rng = np.random.default_rng(5)
    w = (np.abs(rng.standard_normal(800)) + 0.5).astype(np.float32)
    for weights in (None, w):
        sol = cd.lasso(jnp.asarray(X), jnp.asarray(y), lam, options=opts,
                       weights=None if weights is None
                       else jnp.asarray(weights))
        x0 = np.asarray(sol.x)
        rj, rt = _polish_both(X, y, x0, lam, weights=weights,
                              target_rel_gap=1e-7)
        assert rt.converged and rt.rel_gap <= 1e-7
        _same_polish(rj, rt)
        gap0, _ = tcd.lasso_duality_gap_compensated(X, y, x0, lam, weights,
                                                    device="cpu")
        assert rt.gap <= gap0
        gap, primal = tcd.lasso_duality_gap_compensated(
            X, y, rt.beta, lam, weights, device="cpu")
        assert gap / primal <= 1.1e-7


def test_polish_working_set_growth_and_cap():
    """The working set grows past its first allocation (β = 0 start, an
    optimal support above 128 columns), and a support over ``support_cap``
    gets an honest certificate with ``converged=False`` — as in JAX, at a
    smaller shape than tests/test_diagnostics.py:233."""
    X, y = _gen(400, 450, 160, seed=23)
    lam = 0.02 * float(np.max(np.abs(X.astype(np.float64).T
                                     @ y.astype(np.float64))) / 400)
    rj, rt = _polish_both(X, y, np.zeros(450, np.float32), lam,
                          target_rel_gap=1e-7, max_rounds=10)
    assert rt.converged, (rt.rel_gap, rt.rounds, rt.support_size)
    assert rt.support_size > 128
    _same_polish(rj, rt)
    rng = np.random.default_rng(3)
    beta_big = np.zeros(450, np.float64)
    beta_big[rng.choice(450, 300, replace=False)] = 0.1
    rj2, rt2 = _polish_both(X, y, beta_big, lam, support_cap=128)
    assert not rt2.converged and rt2.rounds == rj2.rounds == 0
    assert np.isfinite(rt2.gap) and np.isfinite(rt2.rel_gap)
    np.testing.assert_allclose(rt2.gap, rj2.gap, rtol=1e-9)


# -- the sqrt certificate, loadings_f64 and the three other polishes ----------


def _f32_start(estimator, X, y, lam, **kw):
    """An f32-accuracy start: the JAX package's own f32 solve."""
    sol = estimator(jnp.asarray(X), jnp.asarray(y), lam, **kw)
    return np.asarray(sol.x)


@pytest.mark.parametrize("weighted", [False, True])
def test_sqrt_kkt_compensated_matches_jax(weighted):
    """tests/test_diagnostics.py:332's certificate on a converged f32 sqrt
    solve: the port reads the exact f64 gradient everywhere, the JAX
    package where the certificate can read it; 1e-12 of the threshold
    scale (kkt_rel is relative to it), ‖r‖ to rtol 1e-12."""
    X, y = _gen(150, 400, 8, seed=9)
    lam = 1.1 * float(np.sqrt(2 * np.log(400)))
    w = ((np.abs(np.random.default_rng(5).standard_normal(400)) + 0.2)
         if weighted else None)
    beta = _f32_start(cd.sqrt_lasso, X, y, lam, standardize_X=False,
                      weights=None if w is None else w.astype(np.float32),
                      options=cd.CDOptions(opt_tol=1e-7, randomize=False))
    assert np.count_nonzero(beta)
    with jax.enable_x64(True):
        kj, rj = cd.sqrt_lasso_kkt_compensated(X, y, beta, lam, weights=w)
    kt, rt = tcd.sqrt_lasso_kkt_compensated(X, y, beta, lam, weights=w,
                                            device="cpu")
    np.testing.assert_allclose(rt, rj, rtol=1e-12)
    np.testing.assert_allclose(kt, kj, rtol=1e-9, atol=1e-12)
    assert 0.0 < kt < 1e-3


def test_loadings_f64_matches_jax():
    """Column-chunked f64 loadings over an f32 design, p = 700 across
    chunks of 256 with a ragged tail: rtol 1e-12."""
    rng = np.random.default_rng(6)
    X = rng.standard_normal((80, 700)).astype(np.float32)
    r = rng.standard_normal(80)
    with jax.enable_x64(True):
        ref = np.asarray(jcomp.loadings_f64(jnp.asarray(X), jnp.asarray(r),
                                            col_chunk=256))
    out = tcd.loadings_f64(torch.as_tensor(X), torch.as_tensor(r),
                           col_chunk=256)
    assert out.dtype == torch.float64 and out.shape == (700,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12)
    np.testing.assert_allclose(
        out.numpy(), np.sqrt(np.mean((X.astype(np.float64)
                                      * r[:, None]) ** 2, axis=0)),
        rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("col_chunk", [128, 2048])
def test_loadings_f64_matches_jax_by_design_dtype(dtype, col_chunk):
    """``loadings_f64`` over a float32 and a float64 design, in chunks
    narrower than p and one chunk wider (the default), against the JAX
    package's at rtol 1e-12."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((90, 500)).astype(dtype)
    r = rng.standard_normal(90)
    with jax.enable_x64(True):
        ref = np.asarray(jcomp.loadings_f64(jnp.asarray(X), jnp.asarray(r),
                                            col_chunk=col_chunk))
    out = tcd.loadings_f64(torch.as_tensor(X), torch.as_tensor(r),
                           col_chunk=col_chunk)
    assert out.dtype == torch.float64 and out.shape == (500,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12)


@pytest.mark.parametrize("weighted", [False, True])
def test_polish_sqrt_lasso_reaches_target(weighted):
    """Twin of tests/test_diagnostics.py:436: from the f32 sqrt solve both
    packages certify the compensated relative KKT ≤ 1e-7 in the same
    rounds, and the polished β agree to 1e-9."""
    X, y = _gen(200, 400, 8, seed=13)
    lam = 1.1 * float(np.sqrt(2 * np.log(400)))
    w = ((np.abs(np.random.default_rng(7).standard_normal(400)) + 0.5)
         .astype(np.float32) if weighted else None)
    x0 = _f32_start(cd.sqrt_lasso, X, y, lam, standardize_X=False,
                    weights=None if w is None else jnp.asarray(w),
                    options=cd.CDOptions(randomize=False))
    with jax.enable_x64(True):
        rj = cd.polish_sqrt_lasso(X, y, x0, lam, weights=w)
    rt = tcd.polish_sqrt_lasso(X, y, x0, lam, weights=w, device="cpu")
    assert rt.converged and rt.kkt_rel <= 1e-7
    assert (rt.converged, rt.rounds, rt.support_size) == \
        (rj.converged, rj.rounds, rj.support_size)
    np.testing.assert_allclose(rt.beta.numpy(), np.asarray(rj.beta),
                               atol=1e-9)
    np.testing.assert_allclose(rt.norm_r, rj.norm_r, rtol=1e-12)
    kkt_chk, rn = tcd.sqrt_lasso_kkt_compensated(X, y, rt.beta, lam,
                                                 weights=w, device="cpu")
    assert kkt_chk <= 1.1e-7 and abs(rn - rt.norm_r) / rn < 1e-12


def test_polish_sqrt_lasso_cold_start_and_cap():
    """Twin of tests/test_diagnostics.py:546 (from β = 0 the KKT
    augmentation finds the support), and a support over ``support_cap``:
    an honest certificate with ``converged=False``, as in JAX."""
    X, y = _gen(200, 300, 8, seed=31)
    lam = 1.1 * float(np.sqrt(2 * np.log(300)))
    with jax.enable_x64(True):
        rj = cd.polish_sqrt_lasso(X, y, np.zeros(300), lam)
    rt = tcd.polish_sqrt_lasso(X, y, np.zeros(300), lam, device="cpu")
    assert rt.converged and rt.kkt_rel <= 1e-7 and rt.rounds == rj.rounds
    np.testing.assert_allclose(rt.beta.numpy(), np.asarray(rj.beta),
                               atol=1e-9)
    rng = np.random.default_rng(3)
    big = np.zeros(300)
    big[rng.choice(300, 200, replace=False)] = 0.05
    with jax.enable_x64(True):
        rj2 = cd.polish_sqrt_lasso(X, y, big, lam, support_cap=128)
    rt2 = tcd.polish_sqrt_lasso(X, y, big, lam, support_cap=128,
                                device="cpu")
    assert not rt2.converged and rt2.rounds == rj2.rounds == 0
    np.testing.assert_allclose(rt2.kkt_rel, rj2.kkt_rel, rtol=1e-9)


def test_polish_scaled_lasso_fixed_point():
    """Twin of tests/test_diagnostics.py:463: the f64 (β, σ) fixed point
    from the f32 scaled-lasso solve, in both packages alike."""
    X, y = _gen(200, 400, 8, seed=17)
    lam = float(np.sqrt(2 * np.log(400) / 200))
    io = cd.IterLassoOptions(options_cd=cd.CDOptions(randomize=False))
    x0 = _f32_start(cd.scaled_lasso, X, y, lam, options=io)
    with jax.enable_x64(True):
        rj = cd.polish_scaled_lasso(X, y, x0, lam)
    rt = tcd.polish_scaled_lasso(X, y, x0, lam, device="cpu")
    assert rt.converged, (rt.rel_gap, rt.sigma_rel_change, rt.sigma_rounds)
    assert rt.rel_gap <= 1e-7 and rt.sigma_rel_change <= 1e-7
    assert (rt.sigma_rounds, rt.rounds) == (rj.sigma_rounds, rj.rounds)
    np.testing.assert_allclose(rt.beta.numpy(), np.asarray(rj.beta),
                               atol=1e-9)
    np.testing.assert_allclose(rt.sigma, rj.sigma, rtol=1e-10)
    beta = rt.beta.numpy()
    r = y.astype(np.float64) - X.astype(np.float64) @ beta
    assert abs(np.sqrt(r @ r / 200) - rt.sigma) / rt.sigma < 1e-9
    gap, primal = tcd.lasso_duality_gap_compensated(
        X, y, beta, lam * rt.sigma, device="cpu")
    assert gap / primal <= 1.1e-7


def test_polish_feasible_lasso_fixed_point():
    """Twin of tests/test_diagnostics.py:485: the f64 (β, Γ) loading fixed
    point from the f32 feasible-lasso solve, in both packages alike."""
    X, y = _gen(200, 400, 8, seed=19)
    lam0 = float(np.sqrt(2 * np.log(400) / 200))
    io = cd.IterLassoOptions(options_cd=cd.CDOptions(randomize=False))
    x0 = _f32_start(cd.feasible_lasso, X, y, lam0, options=io)
    with jax.enable_x64(True):
        rj = cd.polish_feasible_lasso(X, y, x0, lam0)
    rt = tcd.polish_feasible_lasso(X, y, x0, lam0, device="cpu")
    assert rt.converged, (rt.rel_gap, rt.loading_rel_change,
                          rt.loading_rounds)
    assert rt.rel_gap <= 1e-7 and rt.loading_rel_change <= 1e-7
    assert (rt.loading_rounds, rt.rounds) == (rj.loading_rounds, rj.rounds)
    np.testing.assert_allclose(rt.beta.numpy(), np.asarray(rj.beta),
                               atol=1e-9)
    np.testing.assert_allclose(rt.loadings.numpy(), np.asarray(rj.loadings),
                               rtol=1e-10)
    beta = rt.beta.numpy()
    X64 = X.astype(np.float64)
    r = y.astype(np.float64) - X64 @ beta
    gam_chk = np.sqrt(np.mean((X64 * r[:, None]) ** 2, axis=0))
    assert float(np.max(np.abs(gam_chk - rt.loadings.numpy()))
                 / np.max(gam_chk)) < 1e-12
    gap, primal = tcd.lasso_duality_gap_compensated(
        X, y, beta, lam0, weights=rt.loadings, device="cpu")
    assert gap / primal <= 1.1e-7


def test_col_chunk_is_taken_and_ignored():
    """The JAX package's ``col_chunk=`` keyword: the certificates and the
    polishes take it (tests/test_diagnostics.py:198-199's call), check that
    it is a positive int and return what they return without it; through
    ``polish_scaled_lasso(**polish_kw)`` too."""
    X, y = _gen(200, 300, 8, seed=3)
    rng = np.random.default_rng(4)
    beta = np.zeros(300, np.float32)
    beta[rng.choice(300, 12, replace=False)] = rng.standard_normal(
        12).astype(np.float32)
    w = np.abs(rng.standard_normal(300)).astype(np.float32) + 0.5
    gap, _ = tcd.lasso_duality_gap_compensated(X, y, beta, 0.2, w,
                                               device="cpu")
    gap2, _ = tcd.lasso_duality_gap_compensated(X, y, beta, 0.2, w,
                                                col_chunk=128, device="cpu")
    assert gap2 == gap
    lam_sq = 1.1 * float(np.sqrt(2 * np.log(300)))
    assert (tcd.sqrt_lasso_kkt_compensated(X, y, beta, lam_sq, col_chunk=128,
                                           device="cpu")
            == tcd.sqrt_lasso_kkt_compensated(X, y, beta, lam_sq,
                                              device="cpu"))
    for fn, lam, kw in ((tcd.polish_lasso, 0.2, {}),
                        (tcd.polish_sqrt_lasso, lam_sq, {}),
                        (tcd.polish_scaled_lasso, 0.1,
                         {"max_sigma_rounds": 1})):
        a = fn(X, y, beta, lam, device="cpu", **kw)
        b = fn(X, y, beta, lam, col_chunk=128, device="cpu", **kw)
        assert torch.equal(a.beta, b.beta)
    for bad in (0, -4, 2.5, True):
        with pytest.raises(ValueError):
            tcd.lasso_duality_gap_compensated(X, y, beta, 0.2,
                                              col_chunk=bad, device="cpu")
        with pytest.raises(ValueError):
            tcd.polish_sqrt_lasso(X, y, beta, lam_sq, col_chunk=bad,
                                  device="cpu")
