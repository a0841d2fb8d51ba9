"""PyTorch port: the slice as a whole — ``lasso``, ``lasso_path`` (scan) and
``coordinate_descent`` — against the JAX package, the NumPy oracle and the
duality gap.

f64 runs use ``randomize=False`` (JAX and torch visit orders cannot match
when randomized) with compaction forced on, as tests/test_compact.py does,
so the working-set path runs; with identical trajectories the two packages
agree to rounding.  f32 runs are held against the JAX plain path
(``use_pallas=False``) at 5e-6, as tests/test_fused_check.py does.
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
from oracle import cd_lasso  # noqa: E402

BASE = cd.CDOptions(block_size=16, compact_size=64, randomize=False)


def _gen(n, p, s, seed, dtype=np.float64, noise=0.3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    sup = rng.choice(p, s, replace=False)
    beta[sup] = rng.standard_normal(s) + np.sign(rng.standard_normal(s))
    y = X @ beta + noise * rng.standard_normal(n)
    return X.astype(dtype), y.astype(dtype)


def _both_lasso(X, y, lam, opts, weights=None):
    sj = cd.lasso(jnp.asarray(X), jnp.asarray(y), lam, options=opts,
                  weights=None if weights is None else jnp.asarray(weights))
    st = tcd.lasso(torch.as_tensor(X), torch.as_tensor(y), lam,
                   options=options_from_jax(opts),
                   weights=None if weights is None else
                   torch.as_tensor(weights), device="cpu")
    return np.asarray(sj.x), st


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("weighted", [False, True])
def test_lasso_f64_compact_matches_jax(seed, weighted):
    X, y = _gen(120, 400, 8, seed)
    w = (0.5 + np.abs(np.random.default_rng(seed + 10).standard_normal(400))
         if weighted else None)
    xj, st = _both_lasso(X, y, 0.1, BASE.replace(compact=True), w)
    np.testing.assert_allclose(st.x.numpy(), xj, atol=1e-10)
    np.testing.assert_allclose(float(st.sigma),
                               float(np.std(y - X @ xj, ddof=1)), rtol=1e-9)


def test_lasso_f64_dense_matches_jax_and_oracle():
    X, y = _gen(100, 60, 6, 3)
    xj, st = _both_lasso(X, y, 0.08, BASE.replace(compact=False,
                                                  opt_tol=1e-12))
    np.testing.assert_allclose(st.x.numpy(), xj, atol=1e-10)
    xo, _ = cd_lasso(X, y, 0.08)
    np.testing.assert_allclose(st.x.numpy(), xo, atol=1e-8)


def test_lasso_cold_start_continuation_matches_jax():
    """warm_start=False: λ-continuation from λmax with the secant
    extrapolation across continuation steps (compaction on)."""
    X, y = _gen(120, 300, 6, 4)
    opts = BASE.replace(compact=True, warm_start=False, num_steps=6)
    xj, st = _both_lasso(X, y, 0.05, opts)
    np.testing.assert_allclose(st.x.numpy(), xj, atol=1e-10)


@pytest.mark.parametrize("standardize,extrapolate", [(True, None),
                                                     (False, None),
                                                     (False, True)])
def test_lasso_path_f64_matches_jax(standardize, extrapolate):
    """The scan with the state and working-set cache carried across points;
    ``extrapolate=True`` adds the secant warm start along the path."""
    X, y = _gen(120, 300, 6, 5)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.03), 8))
    opts = BASE.replace(compact=True, extrapolate=extrapolate)
    pj = cd.lasso_path(jnp.asarray(X), jnp.asarray(y), lams, options=opts,
                       standardize_X=standardize, path_batch=0)
    pt = tcd.lasso_path(torch.as_tensor(X), torch.as_tensor(y), lams,
                        options=options_from_jax(opts),
                        standardize_X=standardize, device="cpu")
    np.testing.assert_allclose(pt.beta_path.numpy(),
                               np.asarray(pj.beta_path), atol=1e-10)
    np.testing.assert_allclose(pt.lam_path.numpy(), np.asarray(pj.lam_path))


def test_lasso_path_max_hat_s_truncates_like_jax():
    X, y = _gen(100, 200, 10, 6)
    lams = np.exp(np.linspace(np.log(0.6), np.log(0.02), 10))
    opts = BASE.replace(compact=True)
    pj = cd.lasso_path(jnp.asarray(X), jnp.asarray(y), lams, options=opts,
                       max_hat_s=5, path_batch=0)
    pt = tcd.lasso_path(torch.as_tensor(X), torch.as_tensor(y), lams,
                        options=options_from_jax(opts), max_hat_s=5,
                        device="cpu")
    assert pt.beta_path.shape == tuple(pj.beta_path.shape)
    assert pt.beta_path.shape[0] < len(lams)
    np.testing.assert_allclose(pt.beta_path.numpy(),
                               np.asarray(pj.beta_path), atol=1e-10)


def test_lasso_f32_matches_jax_plain():
    X, y = _gen(200, 600, 10, 0, np.float32, noise=0.1)
    xj, st = _both_lasso(X, y, 0.15, cd.CDOptions(use_pallas=False))
    np.testing.assert_allclose(st.x.numpy(), xj, atol=5e-6)
    assert (st.x.numpy() != 0).sum() == (xj != 0).sum()


def test_lasso_path_f32_matches_jax_plain():
    X, y = _gen(150, 500, 8, 2, np.float32, noise=0.1)
    lams = np.geomspace(0.5, 0.05, 10).astype(np.float32)
    opts = cd.CDOptions(use_pallas=False, opt_tol=1e-6)
    pj = cd.lasso_path(jnp.asarray(X), jnp.asarray(y), lams, options=opts,
                       path_batch=0)
    pt = tcd.lasso_path(torch.as_tensor(X), torch.as_tensor(y), lams,
                        options=options_from_jax(opts), device="cpu")
    np.testing.assert_allclose(pt.beta_path.numpy(),
                               np.asarray(pj.beta_path), atol=5e-6)


def test_coordinate_descent_matches_jax():
    X, y = _gen(80, 50, 5, 7)
    opts = BASE.replace(compact=False)
    bj, rj = cd.coordinate_descent(jnp.zeros(50), cd.LeastSquaresLoss(
        jnp.asarray(y), jnp.asarray(X)), cd.ProxL1(0.1), opts)
    bt, rt = tcd.coordinate_descent(
        torch.zeros(50, dtype=torch.float64),
        tcd.LeastSquaresLoss(torch.as_tensor(y), torch.as_tensor(X)),
        tcd.ProxL1(0.1), options_from_jax(opts), device="cpu")
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-10)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-10)


def test_duality_gap_and_kkt_match_jax():
    X, y = _gen(90, 70, 5, 8)
    rng = np.random.default_rng(8)
    beta = rng.standard_normal(70) * (rng.random(70) < 0.2)
    w = 0.5 + rng.random(70)
    Xt, yt, bt, wt = map(torch.as_tensor, (X, y, beta, w))
    for weights, tw in ((None, None), (jnp.asarray(w), wt)):
        gj = cd.lasso_duality_gap(jnp.asarray(X), jnp.asarray(y),
                                  jnp.asarray(beta), 0.1, weights)
        gt = tcd.lasso_duality_gap(Xt, yt, bt, 0.1, tw)
        np.testing.assert_allclose(float(gt), float(gj), rtol=1e-12)
        kj = cd.lasso_kkt_residual(jnp.asarray(X), jnp.asarray(y),
                                   jnp.asarray(beta), 0.1, weights)
        kt = tcd.lasso_kkt_residual(Xt, yt, bt, 0.1, tw)
        np.testing.assert_allclose(float(kt), float(kj), rtol=1e-12)
        g64j = cd.lasso_duality_gap_f64(jnp.asarray(X), jnp.asarray(y),
                                        jnp.asarray(beta), 0.1, weights)
        g64t = tcd.lasso_duality_gap_f64(Xt, yt, bt, 0.1, tw, device="cpu")
        np.testing.assert_allclose(g64t, g64j, rtol=1e-12)


def test_solution_gap_is_small():
    """Converged at opt_tol 1e-7 on the coordinate steps: the relative gap
    sits at that level."""
    X, y = _gen(150, 400, 8, 9)
    st = tcd.lasso(torch.as_tensor(X), torch.as_tensor(y), 0.1,
                   options=tcd.CDOptions(block_size=16, randomize=False,
                                         compact=True, compact_size=64),
                   device="cpu")
    gap, primal = tcd.lasso_duality_gap_f64(torch.as_tensor(X),
                                            torch.as_tensor(y), st.x, 0.1,
                                            device="cpu")
    assert 0 <= gap / primal < 1e-6


def test_randomized_visit_orders_converge():
    """randomize=True draws block and coordinate orders from a
    torch.Generator (they cannot match jax.random); the solution is the
    same optimum."""
    X, y = _gen(120, 200, 6, 10)
    opts = BASE.replace(randomize=True, compact=False, opt_tol=1e-10)
    xj, st = _both_lasso(X, y, 0.1, opts)
    np.testing.assert_allclose(st.x.numpy(), xj, atol=1e-7)


def test_path_batch_and_other_losses_raise():
    """Bad path arguments raise; so do a penalty and a loss that are none of
    the package's (the JAX package's ``ProxL1Group`` is foreign here),
    while the port's ``ProxL1Group`` routes to the group engine."""
    X, y = map(torch.as_tensor, _gen(30, 40, 3, 0))
    with pytest.raises(ValueError):
        tcd.lasso_path(X, y, [0.5, 0.1], path_batch=-1, device="cpu")
    with pytest.raises(ValueError):
        tcd.lasso_path(X, y, [0.5, 0.1], path_batch=8, coarse_stride=0,
                       device="cpu")
    with pytest.raises(ValueError):
        tcd.lasso_path(X, y, [0.5, 0.1], scan_chunk=0, device="cpu")

    class _Other:
        X = torch.zeros(3, 2)

    with pytest.raises(NotImplementedError):
        tcd.coordinate_descent(torch.zeros(2), _Other(), tcd.ProxL1(0.1))
    with pytest.raises(NotImplementedError):
        tcd.coordinate_descent(torch.zeros(40, dtype=torch.float64),
                               tcd.LeastSquaresLoss(y, X),
                               cd.ProxL1Group(jnp.asarray(0.1), 2),
                               device="cpu")
    opts = tcd.CDOptions(opt_tol=1e-9, randomize=False)
    routed = tcd.coordinate_descent(torch.zeros(40, dtype=torch.float64),
                                    tcd.LeastSquaresLoss(y, X),
                                    tcd.ProxL1Group(0.1, 2), opts,
                                    device="cpu")
    direct = tcd.group_coordinate_descent(torch.zeros(40, dtype=torch.float64),
                                          tcd.LeastSquaresLoss(y, X),
                                          tcd.ProxL1Group(0.1, 2), opts,
                                          device="cpu")
    assert torch.equal(routed[0], direct[0]) and torch.equal(routed[1],
                                                            direct[1])
    assert int((routed[0] != 0).sum())


def _chunk_problem(n, p, s, seed, noise):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    y = X[:, :s] @ rng.standard_normal(s) + noise * rng.standard_normal(n)
    return X, y, np.abs(X.T @ y / n).max()


@pytest.mark.parametrize("variant", ["plain", "randomized", "compact"])
def test_lasso_path_scan_chunked_bitwise(variant):
    """Twin of ``test_lasso.py::test_lasso_path_scan_chunked_bitwise``: the
    scan in segments equals the single scan bit for bit, for chunk sizes
    that split the grid, chunk = 1, the grid's length and beyond it."""
    X, y, lam_max = _chunk_problem(60, 48, 6, 2, 0.3)
    lam_path = lam_max * np.logspace(-0.2, -1.5, 9)
    opts = {"plain": tcd.CDOptions(opt_tol=1e-10, block_size=16),
            "randomized": tcd.CDOptions(opt_tol=1e-10, block_size=16,
                                        randomize=True),
            "compact": tcd.CDOptions(opt_tol=1e-10, block_size=8,
                                     compact=True, compact_size=16)}[variant]
    if variant != "randomized":
        opts = opts.replace(randomize=False)
    ref = tcd.lasso_path(X, y, lam_path, options=opts, path_batch=0,
                         device="cpu")
    assert int((ref.beta_path[-1] != 0).sum()) > 0
    for ch in (1, 4, 9, 20):
        chunked = tcd.lasso_path(X, y, lam_path, options=opts, path_batch=0,
                                 scan_chunk=ch, device="cpu")
        assert chunked.beta_path.shape == ref.beta_path.shape
        assert torch.equal(chunked.beta_path, ref.beta_path), \
            f"chunk={ch} diverged from the single scan"


def test_lasso_path_scan_chunked_early_stop():
    """Twin of ``test_lasso.py::test_lasso_path_scan_chunked_early_stop``:
    the ``max_hat_s`` truncation is the same with ``scan_chunk``, whether
    the stop would fall inside a segment or on its edge."""
    X, y, lam_max = _chunk_problem(60, 30, 10, 3, 0.1)
    lam_path = lam_max * np.logspace(0, -3, 20)
    opts = tcd.CDOptions(opt_tol=1e-10, block_size=16, randomize=False)
    kw = dict(options=opts, max_hat_s=6, standardize_X=False, path_batch=0,
              device="cpu")
    ref = tcd.lasso_path(X, y, lam_path, **kw)
    k = ref.beta_path.shape[0]
    assert 1 < k < 20
    for ch in (3, 7, k):
        chunked = tcd.lasso_path(X, y, lam_path, scan_chunk=ch, **kw)
        assert torch.equal(chunked.beta_path, ref.beta_path)
        assert torch.equal(chunked.lam_path, ref.lam_path)


def test_refit_lasso_path_matches_jax():
    X, y, lam_max = _chunk_problem(60, 30, 10, 3, 0.1)
    lam_path = lam_max * np.logspace(0, -2, 8)
    opts = cd.CDOptions(opt_tol=1e-11, block_size=16, randomize=False)
    jp = cd.lasso_path(X, y, lam_path, options=opts, standardize_X=False)
    tp = tcd.lasso_path(X, y, lam_path, options=options_from_jax(opts),
                        standardize_X=False, device="cpu")
    jr = cd.refit_lasso_path(jp, X, y)
    tr = tcd.refit_lasso_path(tp, X, y, device="cpu")
    assert set(tr) == set(jr) and len(tr) > 2
    for S, coef in tr.items():
        np.testing.assert_allclose(coef, jr[S], atol=1e-10)
        if S:
            ref = np.linalg.lstsq(X[:, list(S)], y, rcond=None)[0]
            np.testing.assert_allclose(coef, ref, atol=1e-8)
        else:
            assert coef.shape == (0,)


def test_refit_lasso_path_min_norm_when_rank_deficient():
    """Column 1 copied into column 2, both in the support: the refit is the
    minimum-norm least-squares solution, as numpy's ``lstsq(rcond=None)``
    gives it (the two copies share the coefficient equally)."""
    X, y = _gen(50, 8, 3, 4)
    X[:, 2] = X[:, 1]
    beta = np.zeros((1, 8))
    beta[0, [0, 1, 2, 5]] = 1.0
    path = tcd.LassoPath(torch.tensor([0.1]), torch.as_tensor(beta))
    out = tcd.refit_lasso_path(path, X, y, device="cpu")
    coef = out[(0, 1, 2, 5)].numpy()
    ref = np.linalg.lstsq(X[:, [0, 1, 2, 5]], y, rcond=None)[0]
    np.testing.assert_allclose(coef, ref, atol=1e-10)
    assert abs(coef[1] - coef[2]) < 1e-10


def test_entry_points_run_on_cuda_unless_cpu_is_asked(monkeypatch):
    """The device rule: without a usable CUDA device every entry point
    raises (pointing at ``device="cpu"``) instead of running on the CPU
    unasked; with ``device="cpu"`` it runs there, on numpy inputs too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _gen(40, 30, 3, 11)
    beta = np.zeros(30)
    calls = {
        "lasso": lambda **kw: tcd.lasso(X, y, 0.1, **kw),
        "lasso_path": lambda **kw: tcd.lasso_path(X, y, [0.5, 0.2], **kw),
        "coordinate_descent": lambda **kw: tcd.coordinate_descent(
            torch.zeros(30, dtype=torch.float64), tcd.LeastSquaresLoss(
                torch.as_tensor(y), torch.as_tensor(X)), tcd.ProxL1(0.1),
            **kw),
        "polish_lasso": lambda **kw: tcd.polish_lasso(X, y, beta, 0.1, **kw),
        "lasso_duality_gap_compensated":
            lambda **kw: tcd.lasso_duality_gap_compensated(X, y, beta, 0.1,
                                                           **kw),
        "lasso_duality_gap_f64": lambda **kw: tcd.lasso_duality_gap_f64(
            X, y, beta, 0.1, **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")
    sol = tcd.lasso(X, y, 0.1, device="cpu")
    assert sol.x.device.type == "cpu" and sol.x.dtype == torch.float64
