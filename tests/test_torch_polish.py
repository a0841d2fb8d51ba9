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
