"""PyTorch port: the batched λ path (``lasso_path(path_batch > 0)``) and its
lane primitives (``ops/batched_certify.py``) against the JAX package.

Twins of tests/test_compact.py's batched-path tests, at smaller shapes
(the port's plain f64 path is eager PyTorch on the CPU): the port's
batched path is held against JAX's batched path and against the port's
own scan at f64 (atol 1e-7), with ``RuntimeWarning`` raised as an error
where JAX's test does, so a fallback cannot make the comparison vacuous.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import coordinatedescent_jl_tpu as cd  # noqa: E402
from coordinatedescent_jl_tpu.ops import batched_certify as jbc  # noqa: E402
import coordinatedescent_jl_tpu_torch as tcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.ops import (  # noqa: E402
    batched_certify as tbc)
from coordinatedescent_jl_tpu_torch.utils.convert import (  # noqa: E402
    options_from_jax)
from coordinatedescent_jl_tpu_torch.utils.options import (  # noqa: E402
    auto_batch_lanes)


def _problem(n, p, s, seed, noise, lo, hi, L):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    b = np.zeros(p)
    b[rng.choice(p, s, replace=False)] = rng.standard_normal(s)
    y = X @ b + noise * rng.standard_normal(n)
    lam_max = float(np.abs(X.T @ y / n).max())
    return X, y, lam_max * np.logspace(lo, hi, L)


def _paths(X, y, lams, opts, stats=None, **kw):
    """(JAX path, port path) with the same arguments; the port on the CPU,
    filling ``stats``."""
    pj = cd.lasso_path(X, y, lams, options=opts, standardize_X=False, **kw)
    pt = tcd.lasso_path(X, y, lams, options=options_from_jax(opts),
                        standardize_X=False, device="cpu", stats=stats, **kw)
    return np.asarray(pj.beta_path), pt.beta_path.numpy()


def test_batched_path_matches_scan():
    """Several chunks of lanes (9 refined points in chunks of 4), no
    fallback, and the max_hat_s truncation."""
    X, y, lams = _problem(150, 300, 6, 23, 0.3, -0.1, -1.5, 13)
    opts = cd.CDOptions(opt_tol=1e-10, randomize=False, block_size=32)
    topts = options_from_jax(opts)
    scan = tcd.lasso_path(X, y, lams, options=topts, standardize_X=False,
                          device="cpu").beta_path.numpy()
    st = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        bj, bt = _paths(X, y, lams, opts, path_batch=4, coarse_stride=4,
                        stats=st)
        p4 = tcd.lasso_path(X, y, lams, options=topts, standardize_X=False,
                            max_hat_s=4, path_batch=4, coarse_stride=4,
                            device="cpu")
    # f64 runs never take the near-tol stall escape
    rounds = st.pop("refine_rounds")
    assert st == {"used_batched": True, "batched_certified": True,
                  "stall_escaped_lanes": 0}
    assert rounds >= 1
    np.testing.assert_allclose(bt, bj, atol=1e-7)
    np.testing.assert_allclose(bt, scan, atol=1e-7)
    p3 = tcd.lasso_path(X, y, lams, options=topts, standardize_X=False,
                        max_hat_s=4, device="cpu")
    assert p4.beta_path.shape == p3.beta_path.shape
    assert p4.beta_path.shape[0] < len(lams)
    np.testing.assert_allclose(p4.beta_path.numpy(), p3.beta_path.numpy(),
                               atol=1e-7)


def test_batched_path_saturated_working_set_falls_back():
    """A union support saturating compact_size cannot certify: the port
    warns and returns its exact scan result, as JAX does."""
    X, y, lams = _problem(200, 300, 20, 0, 0.1, -0.1, -1.5, 10)
    opts = cd.CDOptions(opt_tol=1e-9, compact_size=16, block_size=16,
                        compact_rounds=4, randomize=False)
    topts = options_from_jax(opts)
    p1 = tcd.lasso_path(X, y, lams, options=topts, standardize_X=False,
                        device="cpu")
    st = {}
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        p2 = tcd.lasso_path(X, y, lams, options=topts, standardize_X=False,
                            path_batch=8, stats=st, device="cpu")
        assert any("falling back" in str(w.message) for w in ws)
    # the uncertified lanes spent the whole budget, 2 * compact_rounds
    assert st == {"used_batched": True, "batched_certified": False,
                  "stall_escaped_lanes": 0, "refine_rounds": 8}
    np.testing.assert_array_equal(p2.beta_path.numpy(),
                                  p1.beta_path.numpy())
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        pj = cd.lasso_path(X, y, lams, options=opts, standardize_X=False,
                           path_batch=8)
    np.testing.assert_allclose(p2.beta_path.numpy(),
                               np.asarray(pj.beta_path), atol=1e-7)


def test_batched_path_early_stop_kept_points_uncorrupted():
    """Mid-path max_hat_s truncation: post-stop lanes are frozen, and the
    kept points match the scan and JAX's batched path."""
    X, y, lams = _problem(200, 300, 20, 0, 0.1, -0.1, -1.5, 10)
    opts = cd.CDOptions(opt_tol=1e-9, compact_size=64, block_size=16,
                        randomize=False)
    p3 = tcd.lasso_path(X, y, lams, options=options_from_jax(opts),
                        standardize_X=False, max_hat_s=15, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        bj, bt = _paths(X, y, lams, opts, max_hat_s=15, path_batch=8,
                        coarse_stride=3)
    assert bt.shape == tuple(p3.beta_path.shape) == bj.shape
    assert bt.shape[0] < len(lams)
    np.testing.assert_allclose(bt, p3.beta_path.numpy(), atol=1e-7)
    np.testing.assert_allclose(bt, bj, atol=1e-7)


# ---------------------------------------------------------------------------
# Lane primitives, one at a time, on the same inputs
# ---------------------------------------------------------------------------


def _lanes(dtype, seed=5, k=6, n=40, p=96):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(dtype)
    B = (rng.standard_normal((k, p)) * (rng.random((k, p)) < 0.2)).astype(
        dtype)
    R = rng.standard_normal((k, n)).astype(dtype)
    thrw = (rng.random((k, p)) * 20).astype(dtype)
    adiag = np.maximum((X * X).sum(0), 1e-30).astype(dtype)
    return X, B, R, thrw, adiag, np.sqrt(adiag)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kkt_violation_lanes_matches_jax(dtype):
    """f64 at 1e-12; f32 (noise-floor branch) at 1e-5 of max |H| (the GEMM
    adds n products in another order)."""
    arrs = _lanes(dtype)
    X, B, R, thrw, adiag, xnorm = arrs
    ref = np.asarray(jbc.kkt_violation_lanes(
        jnp.asarray(B), jnp.asarray(R), jnp.asarray(thrw), jnp.asarray(X),
        jnp.asarray(adiag), jnp.asarray(xnorm)))
    out = tbc.kkt_violation_lanes(*(torch.as_tensor(a) for a in
                                    (B, R, thrw, X, adiag, xnorm))).numpy()
    atol = 1e-12 if dtype == np.float64 else 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


def test_union_priority_matches_jax():
    _, B, _, H, _, _ = _lanes(np.float64, seed=6)
    cert = np.array([True, False, False, True, False, False])
    hi = 2 * np.max(np.where(cert[:, None], 0.0, H)) + 1.0
    ref = jbc.union_priority(jnp.asarray(B), jnp.asarray(H),
                             jnp.asarray(cert), hi)
    out = tbc.union_priority(torch.as_tensor(B), torch.as_tensor(H),
                             torch.as_tensor(cert), hi)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_union_block_fista_matches_jax():
    """Three 16-wide blocks with one padded slot (threshold finfo.max/8),
    a certified (frozen) lane, and the cross-block gradient updates."""
    rng = np.random.default_rng(7)
    n, Cp, k = 50, 48, 5
    Xs = rng.standard_normal((n, Cp))
    Xs[:, -1] = 0.0
    Ks = Xs.T @ Xs
    R = rng.standard_normal((k, n))
    Bs0 = rng.standard_normal((k, Cp)) * (rng.random((k, Cp)) < 0.3)
    Bs0[:, -1] = 0.0
    thr = rng.random((k, Cp)) * 30
    thr[:, -1] = np.finfo(np.float64).max / 8
    cs0 = R @ Xs
    cert = np.array([False, True, False, False, False])
    opts = cd.CDOptions(block_size=16, block_iters=7)
    ref = jbc.union_block_fista(jnp.asarray(Ks), jnp.asarray(thr),
                                jnp.asarray(Bs0), jnp.asarray(cs0),
                                jnp.asarray(cert), opts, n_sweeps=3)
    out = tbc.union_block_fista(*(torch.as_tensor(a) for a in
                                  (Ks, thr, Bs0, cs0, cert)),
                                options_from_jax(opts), n_sweeps=3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-12)
    np.testing.assert_array_equal(out.numpy()[1], Bs0[1])


def test_stall_escape_update_matches_jax():
    cert = np.array([False, False, False, True, False, False])
    best = np.array([1e-6, 3e-7, 5e-6, 1e-9, 2e-7, np.inf])
    stall = np.array([3, 4, 4, 0, 1, 4], np.int32)
    esc = np.zeros(6, bool)
    mx = np.array([2e-6, 3.5e-7, 6e-6, 1e-9, 5e-8, np.nan])
    frozen = np.array([False, False, False, False, False, True])
    ref = jbc.stall_escape_update(*(jnp.asarray(a) for a in
                                    (cert, best, stall, esc, mx)), 5, 1e-7,
                                  jnp.asarray(frozen))
    out = tbc.stall_escape_update(*(torch.as_tensor(a) for a in
                                    (cert, best, stall, esc, mx)), 5, 1e-7,
                                  torch.as_tensor(frozen))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-12)


def test_auto_batch_lanes():
    """128 lanes only for sub-f64 CUDA tensors on long enough grids; the
    CPU keeps the scan (as the JAX package on its CPU backend)."""
    assert auto_batch_lanes(torch.float32, "cuda", 100, min_points=16) == 128
    assert auto_batch_lanes(torch.float32, "cuda", 15, min_points=16) == 0
    assert auto_batch_lanes(torch.float64, "cuda", 100, min_points=16) == 0
    assert auto_batch_lanes(torch.float32, "cpu", 100, min_points=16) == 0
