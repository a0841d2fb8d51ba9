"""PyTorch port: the symmetric-matrix iterate (``sym_*`` packing and
``symmetric_coordinate_descent``) against the JAX package, on
tests/test_symmetric.py's six cases: the packed numbering, pack / unpack,
and ``symmetric_coordinate_descent`` on the quadratic loss (the
closed-form covariance thresholding and a coupled quadratic), plain path
on the CPU in float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import coordinatedescent_jl_tpu as cd  # noqa: E402
import coordinatedescent_jl_tpu_torch as tcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils.convert import (  # noqa: E402
    options_from_jax)


@pytest.mark.parametrize("p", [1, 3, 10, 128])
def test_sym_num_coordinates_matches_jax(p):
    assert tcd.sym_num_coordinates(p) == cd.sym_num_coordinates(p)
    assert tcd.sym_num_coordinates(p) == p * (p + 1) // 2


@pytest.mark.parametrize("p", [3, 7])
def test_sym_indices_match_jax(p):
    """Packed lower triangle, column-major; (0,0), (1,0), (2,0), (1,1), …"""
    ij = tcd.sym_indices(p)
    assert ij.dtype == torch.int64 and ij.shape == (p * (p + 1) // 2, 2)
    np.testing.assert_array_equal(ij.numpy(), np.asarray(cd.sym_indices(p)))
    if p == 3:
        want = [(0, 0), (1, 0), (2, 0), (1, 1), (2, 1), (2, 2)]
        assert [tuple(row) for row in ij.tolist()] == want


def test_sym_pack_unpack_roundtrip_matches_jax():
    A = np.random.default_rng(0).standard_normal((7, 7))
    M = A + A.T
    v = tcd.sym_pack(torch.as_tensor(M))
    np.testing.assert_array_equal(v.numpy(),
                                  np.asarray(cd.sym_pack(jnp.asarray(M))))
    M2 = tcd.sym_unpack(v, 7)
    np.testing.assert_array_equal(M2.numpy(),
                                  np.asarray(cd.sym_unpack(jnp.asarray(v), 7)))
    np.testing.assert_allclose(M2.numpy(), M, atol=1e-12)
    assert torch.equal(M2, M2.T)


def test_sym_single_coordinate_sets_both_halves():
    """Packed coordinate 1 ↔ (1, 0) sets M[1, 0] and M[0, 1]."""
    v = torch.zeros(tcd.sym_num_coordinates(3), dtype=torch.float64)
    v[1] = 1.0
    M = tcd.sym_unpack(v, 3).numpy()
    assert M[1, 0] == 1.0 and M[0, 1] == 1.0 and np.sum(M != 0) == 2
    np.testing.assert_array_equal(
        M, np.asarray(cd.sym_unpack(jnp.asarray(v.numpy()), 3)))


def _cov_problem(p, seed=1):
    """½‖M − S‖_F² + λ‖M‖_{1,off} over symmetric M, as the packed
    QuadraticLoss ½ v'Dv − (Ds)'v (D: 1 on the diagonal, 2 off it) with
    off-diagonal penalty weight 2; the closed form is soft(S, λ) off the
    diagonal and S on it."""
    A = np.random.default_rng(seed).standard_normal((p, 40))
    S = A @ A.T / 40.0
    ij = tcd.sym_indices(p).numpy()
    offdiag = (ij[:, 0] != ij[:, 1]).astype(np.float64)
    d = 1.0 + offdiag
    s = tcd.sym_pack(torch.as_tensor(S)).numpy()
    return S, np.diag(d), -(d * s), 2.0 * offdiag


def test_symmetric_covariance_thresholding_matches_jax():
    p, lam = 12, 0.15
    S, D, b, w = _cov_problem(p)
    opts = cd.CDOptions(opt_tol=1e-10, randomize=False)
    Mj, _ = cd.symmetric_coordinate_descent(
        jnp.zeros((p, p)), cd.QuadraticLoss(jnp.asarray(D), jnp.asarray(b)),
        cd.ProxL1(lam, jnp.asarray(w)), opts)
    Mt, _ = tcd.symmetric_coordinate_descent(
        torch.zeros((p, p), dtype=torch.float64),
        tcd.QuadraticLoss(torch.as_tensor(D), torch.as_tensor(b)),
        tcd.ProxL1(lam, torch.as_tensor(w)), options_from_jax(opts),
        device="cpu")
    M = Mt.numpy()
    np.testing.assert_allclose(M, np.asarray(Mj), atol=1e-10)
    want = np.sign(S) * np.maximum(np.abs(S) - lam, 0.0)
    off = ~np.eye(p, dtype=bool)
    np.testing.assert_allclose(np.diag(M), np.diag(S), atol=1e-8)
    np.testing.assert_allclose(M[off], want[off], atol=1e-8)
    assert np.array_equal(M, M.T)


def test_symmetric_coupled_quadratic_matches_jax():
    """A non-separable packed quadratic through the block engine: the same
    solution as the JAX package and the packed KKT conditions."""
    p = 6
    q = tcd.sym_num_coordinates(p)
    rng = np.random.default_rng(2)
    Bm = rng.standard_normal((q, q))
    A = Bm @ Bm.T / q + np.eye(q)
    bvec = rng.standard_normal(q)
    lam = 0.3
    opts = cd.CDOptions(opt_tol=1e-11, randomize=False)
    Mj, _ = cd.symmetric_coordinate_descent(
        jnp.zeros((p, p)), cd.QuadraticLoss(jnp.asarray(A), jnp.asarray(bvec)),
        cd.ProxL1(lam), opts)
    Mt, _ = tcd.symmetric_coordinate_descent(
        np.zeros((p, p)),
        tcd.QuadraticLoss(torch.as_tensor(A), torch.as_tensor(bvec)),
        tcd.ProxL1(lam), options_from_jax(opts), device="cpu")
    np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), atol=1e-9)
    v = tcd.sym_pack(Mt).numpy()
    g = A @ v + bvec
    kkt = np.where(v != 0, np.abs(g + lam * np.sign(v)),
                   np.maximum(np.abs(g) - lam, 0.0))
    assert np.max(kkt) < 1e-7
    assert torch.equal(Mt, Mt.T)


def test_symmetric_device_rule(monkeypatch):
    """Runs on the GPU unless the CPU is asked for: without one it raises."""
    S, D, b, w = _cov_problem(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tcd.symmetric_coordinate_descent(
            np.zeros((4, 4)), tcd.QuadraticLoss(torch.as_tensor(D),
                                                torch.as_tensor(b)),
            tcd.ProxL1(0.1, torch.as_tensor(w)))
