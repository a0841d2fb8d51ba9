"""PyTorch port: the Sqrt-, Scaled- and Feasible-Lasso estimators, their
helpers and option record against the JAX package (twins of
``tests/test_lasso.py``'s estimator tests).

Inputs come from a numpy seed and go to both packages in float64 on the
CPU; ``randomize=False`` (``jax.random`` orders cannot be reproduced).
Tolerances: β 1e-8, σ and loadings 1e-10, helpers 1e-12.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import coordinatedescent_jl_tpu as cd  # noqa: E402
from coordinatedescent_jl_tpu.utils import helpers as jh  # noqa: E402

import coordinatedescent_jl_tpu_torch as tcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.models import lasso as tlasso  # noqa: E402
from coordinatedescent_jl_tpu_torch.ops import block_cd as tbcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils import convert, host  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils import helpers as th  # noqa: E402

N, P, S, B = 60, 96, 5, 16
CDO = cd.CDOptions(opt_tol=1e-11, block_size=B, randomize=False,
                   num_steps=3, max_iter=5000)
INITS = ["screening", "init_std", "warm_start"]


def _data(seed=2, hetero=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, P))
    eps = rng.standard_normal(N)
    if hetero:
        eps = eps * (1 + 0.5 * np.abs(X[:, 0]))
    y = X[:, :S] @ (2 * np.ones(S)) + eps
    return rng, X, y


def _iter_opts(init, warm=True, **kw):
    return cd.IterLassoOptions(options_cd=CDO.replace(warm_start=warm),
                               init_procedure=init, s_init=S, sigma_init=1.0,
                               **kw)


# -- helpers and options ------------------------------------------------------


def test_loadings_match_jax():
    rng, X, y = _data()
    e = rng.standard_normal(N)
    ref = np.asarray(jh.get_loadings(jnp.asarray(X), jnp.asarray(e)))
    np.testing.assert_allclose(
        th.get_loadings(torch.tensor(X), torch.tensor(e)).numpy(), ref,
        rtol=1e-12)
    # blocked: a ragged last block (p = 90 in blocks of 16), over more than
    # one step of 16 blocks
    Xw = np.concatenate([X] * 4, axis=1)[:, :346]
    prob = tbcd.build_blocked("ls", tcd.CDOptions(block_size=B),
                              torch.ones(346, dtype=torch.float64),
                              X=torch.tensor(Xw), y=torch.tensor(y))
    assert prob.Xb.shape[0] > 16
    ref = np.asarray(jh.get_loadings(jnp.asarray(Xw), jnp.asarray(e)))
    got = th.get_loadings_blocked(prob.Xb, torch.tensor(e), 346)
    assert got.shape == (346,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_blocked_loadings_match_jax_by_dtype(dtype):
    """``get_loadings_blocked`` in the design's own dtype against the JAX
    package's ``get_loadings`` on the same-dtype data: blocks of 128 with a
    ragged last one (p = 300), float64 at 1e-12 and float32 at 1e-5
    relative (sums of N positive float32 terms in another order)."""
    rng, X, y = _data(seed=4)
    Xw = np.concatenate([X] * 4, axis=1)[:, :300].astype(dtype)
    e = rng.standard_normal(N).astype(dtype)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    prob = tbcd.build_blocked("ls", tcd.CDOptions(block_size=128),
                              torch.ones(300, dtype=tdt),
                              X=torch.tensor(Xw), y=torch.tensor(y, dtype=tdt))
    assert prob.Xb.shape == (3, N, 128)
    ref = np.asarray(jh.get_loadings(jnp.asarray(Xw), jnp.asarray(e)))
    got = th.get_loadings_blocked(prob.Xb, torch.tensor(e), 300)
    assert got.shape == (300,) and got.dtype == tdt
    np.testing.assert_allclose(got.numpy(), ref,
                               rtol=1e-5 if dtype == np.float32 else 1e-12)


def test_get_sigma_matches_jax():
    rng, X, y = _data()
    w, r = 0.5 + rng.random(N), rng.standard_normal(N)
    np.testing.assert_allclose(
        float(th.get_sigma(torch.tensor(w), torch.tensor(r))),
        float(jh.get_sigma(jnp.asarray(w), jnp.asarray(r))), rtol=1e-12)


@pytest.mark.parametrize("weighted", [False, True])
def test_screening_inits_match_jax(weighted):
    rng, X, y = _data()
    w = 0.5 + rng.random(N) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.tensor(w)
    Xt, yt = torch.tensor(X), torch.tensor(y)
    idx = jh.find_largest_correlations(jnp.asarray(X), jnp.asarray(y), 7, jw)
    np.testing.assert_array_equal(
        th.find_largest_correlations(Xt, yt, 7, tw).numpy(), np.asarray(idx))
    r = jh.find_init_residuals(jnp.asarray(X), jnp.asarray(y), 7, jw)
    np.testing.assert_allclose(
        th.find_init_residuals(Xt, yt, 7, tw).numpy(), np.asarray(r),
        atol=1e-12)
    if not weighted:
        np.testing.assert_allclose(
            float(th.find_init_sigma(Xt, yt, 7)),
            float(jh.find_init_sigma(jnp.asarray(X), jnp.asarray(y), 7)),
            rtol=1e-12)


def test_screening_init_survives_collinear_columns():
    """The eps-scaled jitter keeps the normal equations defined when the
    top-s columns are duplicates, in both packages alike."""
    rng, X, y = _data()
    X[:, 1] = X[:, 0]
    r = jh.find_init_residuals(jnp.asarray(X), jnp.asarray(y), 3)
    rt = th.find_init_residuals(torch.tensor(X), torch.tensor(y), 3)
    assert bool(torch.isfinite(rt).all())
    np.testing.assert_allclose(rt.numpy(), np.asarray(r), atol=1e-6)


def test_iter_options_same_fields_and_convert():
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(cd.IterLassoOptions)
          if f.name != "options_cd"}
    tf = {f.name: f.default for f in dataclasses.fields(tcd.IterLassoOptions)
          if f.name != "options_cd"}
    assert jf == tf
    assert tcd.IterLassoOptions().options_cd == tcd.CDOptions()
    o = convert.iter_options_from_jax(_iter_opts("init_std", opt_tol=1e-5))
    assert isinstance(o, tcd.IterLassoOptions)
    assert isinstance(o.options_cd, tcd.CDOptions)
    assert (o.init_procedure, o.opt_tol, o.s_init) == ("init_std", 1e-5, S)
    assert o.options_cd.block_size == B and not o.options_cd.randomize
    assert o.replace(max_iter=3).max_iter == 3


# -- sqrt lasso ---------------------------------------------------------------


@pytest.mark.parametrize("mode", ["standardize", "plain", "weights"])
def test_sqrt_lasso_matches_jax(mode):
    rng, X, y = _data()
    kw = dict(standardize_X=mode == "standardize",
              weights=0.5 + rng.random(P) if mode == "weights" else None)
    lam = 2.8
    js = cd.sqrt_lasso(X, y, lam, options=CDO, **kw)
    ts = tcd.sqrt_lasso(X, y, lam, options=convert.options_from_jax(CDO),
                        device="cpu", **kw)
    assert 0 < int((ts.x != 0).sum()) < P
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=1e-8)
    np.testing.assert_allclose(ts.residuals.numpy(), np.asarray(js.residuals),
                               atol=1e-8)
    np.testing.assert_allclose(float(ts.sigma), float(js.sigma), rtol=1e-10)
    if mode == "standardize":
        np.testing.assert_allclose(ts.penalty.weights.numpy(),
                                   np.sqrt((X ** 2).mean(axis=0)), rtol=1e-12)


def test_sqrt_lasso_kkt():
    """Twin of ``test_lasso.py::test_sqrt_lasso_kkt``: ``max|X'r|/‖r‖ ≤ λ``,
    with equality on the support."""
    rng, X, y = _data()
    lam = 2.8
    out = tcd.sqrt_lasso(X, y, lam, standardize_X=False,
                         options=convert.options_from_jax(CDO), device="cpu")
    r, beta = out.residuals.numpy(), out.x.numpy()
    assert np.abs(X.T @ r).max() / np.linalg.norm(r) <= lam * (1 + 1e-5)
    assert np.count_nonzero(beta)
    for j in np.nonzero(beta)[0]:
        assert abs(abs(X[:, j] @ r) / np.linalg.norm(r) - lam) < 1e-5


# -- scaled lasso -------------------------------------------------------------


def _count_solves(monkeypatch):
    """Count the port's outer rounds: its solver calls at the top level
    (the scaled Lasso's rounds are path points, the feasible Lasso's
    solves)."""
    calls = {"n": 0}

    def counted(inner):
        def call(*a, **k):
            calls["n"] += 1
            return inner(*a, **k)
        return call

    for name in ("_path_point", "_solve_at_lambda_ws"):
        monkeypatch.setattr(tlasso, name, counted(getattr(tlasso, name)))
    return calls


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("init", INITS)
def test_scaled_lasso_matches_jax(init, warm):
    rng, X, y = _data()
    lam = np.sqrt(2 * np.log(P) / N)
    io = _iter_opts(init, warm, opt_tol=1e-6)
    beta0 = None
    if init == "warm_start":
        beta0 = np.zeros(P)
        beta0[:S] = 1.5
    js = cd.scaled_lasso(X, y, lam, options=io, beta0=beta0)
    ts = tcd.scaled_lasso(X, y, lam, options=convert.iter_options_from_jax(io),
                          beta0=beta0, device="cpu")
    assert 0 < int((ts.x != 0).sum()) < P
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=1e-8)
    # the penalty level is λ·σ of the last solve: σ to 1e-10
    np.testing.assert_allclose(ts.penalty.lam0, float(js.penalty.lam0),
                               rtol=1e-10)
    np.testing.assert_allclose(float(ts.sigma), float(js.sigma), rtol=1e-10)


def test_scaled_lasso_same_number_of_outer_rounds(monkeypatch):
    """The JAX package does not return its round count; it is read off the
    round cap instead: capped at the port's count it returns the final σ,
    capped one lower another."""
    rng, X, y = _data()
    lam = np.sqrt(2 * np.log(P) / N)
    io = _iter_opts("screening", opt_tol=1e-3)
    calls = _count_solves(monkeypatch)
    reads0 = host.COUNTS["host_reads"]
    ts = tcd.scaled_lasso(X, y, lam, options=convert.iter_options_from_jax(io),
                          device="cpu")
    rounds = calls["n"]
    assert 2 <= rounds < io.max_iter
    assert host.COUNTS["host_reads"] > reads0
    full = float(cd.scaled_lasso(X, y, lam, options=io).penalty.lam0)
    at = float(cd.scaled_lasso(
        X, y, lam, options=io.replace(max_iter=rounds)).penalty.lam0)
    below = float(cd.scaled_lasso(
        X, y, lam, options=io.replace(max_iter=rounds - 1)).penalty.lam0)
    np.testing.assert_allclose(ts.penalty.lam0, full, rtol=1e-10)
    assert at == full and below != full


def test_scaled_lasso_inits_agree_and_kkt():
    """Twin of ``test_lasso.py::test_scaled_lasso_inits_agree``."""
    rng, X, y = _data()
    lam = np.sqrt(2 * np.log(P) / N)
    sols = [tcd.scaled_lasso(
        X, y, lam, device="cpu",
        options=convert.iter_options_from_jax(
            _iter_opts(i, opt_tol=1e-6, max_iter=200)))
        for i in ("screening", "init_std")]
    np.testing.assert_allclose(sols[0].x.numpy(), sols[1].x.numpy(),
                               atol=1e-4)
    r = sols[0].residuals.numpy()
    sig_hat = np.sqrt(np.sum(r ** 2) / N)
    assert np.abs(X.T @ r / N).max() <= lam * sig_hat * (1 + 1e-3)


def test_scaled_lasso_matches_manual_outer_loop():
    """Twin of ``test_lasso.py::test_scaled_lasso_matches_manual_outer_loop``:
    the outer loop is a hand-written loop over oracle Lasso solves."""
    from oracle import cd_lasso

    rng, X, y = _data()
    lam = np.sqrt(2 * np.log(P) / N)
    sol = tcd.scaled_lasso(
        X, y, lam, device="cpu",
        options=convert.iter_options_from_jax(_iter_opts("init_std")))
    sig = 1.0
    for _ in range(20):
        beta, r = cd_lasso(X, y, lam * sig)
        signew = np.sqrt(np.sum(r ** 2) / N)
        if abs(signew - sig) / sig < 1e-2:
            break
        sig = signew
    np.testing.assert_allclose(sol.x.numpy(), beta, atol=1e-6)
    np.testing.assert_allclose(sol.penalty.lam0, lam * sig, rtol=1e-8)


def test_iterated_estimators_reject_unknown_init():
    rng, X, y = _data()
    bad = tcd.IterLassoOptions(init_procedure="nope")
    with pytest.raises(ValueError):
        tcd.scaled_lasso(X, y, 0.1, options=bad, device="cpu")
    with pytest.raises(ValueError):
        tcd.feasible_lasso(X, y, 0.1, options=bad, device="cpu")


# -- feasible lasso -----------------------------------------------------------


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("init", INITS)
def test_feasible_lasso_matches_jax(init, warm):
    rng, X, y = _data(hetero=True)
    lam = 1.1 * np.sqrt(2 * np.log(P) / N)
    io = _iter_opts(init, warm, opt_tol=1e-4)
    beta0 = None
    if init == "warm_start":
        beta0 = np.zeros(P)
        beta0[:S] = 1.5
    js = cd.feasible_lasso(X, y, lam, options=io, beta0=beta0)
    ts = tcd.feasible_lasso(X, y, lam, device="cpu", beta0=beta0,
                            options=convert.iter_options_from_jax(io))
    assert 0 < int((ts.x != 0).sum()) < P
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=1e-8)
    np.testing.assert_allclose(ts.penalty.weights.numpy(),
                               np.asarray(js.penalty.weights), rtol=1e-10)
    np.testing.assert_allclose(float(ts.sigma), float(js.sigma), rtol=1e-10)


def test_feasible_lasso_same_number_of_outer_rounds(monkeypatch):
    """As for the scaled Lasso: the JAX package's round count is read off
    the round cap through the returned loadings."""
    rng, X, y = _data(hetero=True)
    lam = 1.1 * np.sqrt(2 * np.log(P) / N)
    io = _iter_opts("screening", opt_tol=1e-4)
    calls = _count_solves(monkeypatch)
    ts = tcd.feasible_lasso(X, y, lam, device="cpu",
                            options=convert.iter_options_from_jax(io))
    rounds = calls["n"]
    assert 2 <= rounds < io.max_iter

    def jgam(**kw):
        return np.asarray(cd.feasible_lasso(
            X, y, lam, options=io.replace(**kw)).penalty.weights)

    full = jgam()
    np.testing.assert_allclose(ts.penalty.weights.numpy(), full, rtol=1e-10)
    assert np.array_equal(jgam(max_iter=rounds), full)
    assert not np.array_equal(jgam(max_iter=rounds - 1), full)


def test_feasible_lasso_kkt_and_fixed_point():
    """Twin of ``test_lasso.py::test_feasible_lasso_runs_and_kkt``."""
    rng, X, y = _data(hetero=True)
    lam = 1.1 * np.sqrt(2 * np.log(P) / N)
    sol = tcd.feasible_lasso(
        X, y, lam, device="cpu",
        options=convert.iter_options_from_jax(_iter_opts("screening")))
    r, gam = sol.residuals.numpy(), sol.penalty.weights.numpy()
    assert (np.abs(X.T @ r / N) / gam).max() <= lam * (1 + 1e-3)
    gam_check = np.sqrt(np.mean((X * r[:, None]) ** 2, axis=0))
    assert np.max(np.abs(gam - gam_check)) / gam_check.max() < 1e-2


def test_new_entry_points_run_on_cuda_unless_cpu_is_asked(monkeypatch):
    """The device rule for this slice's entry points: without a usable
    CUDA device each raises (pointing at ``device="cpu"``) instead of
    running on the CPU unasked; with ``device="cpu"`` it runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng, X, y = _data()
    X32, y32 = X.astype(np.float32), y.astype(np.float32)
    beta = np.zeros(P)
    beta[:S] = 1.9
    io = tcd.IterLassoOptions(options_cd=tcd.CDOptions(
        block_size=B, randomize=False, opt_tol=1e-6), max_iter=2)
    cdo = io.options_cd
    path = tcd.LassoPath(torch.tensor([0.4]), torch.tensor(beta)[None])
    calls = {
        "refit_lasso_path": lambda **kw: tcd.refit_lasso_path(path, X, y,
                                                              **kw),
        "sqrt_lasso": lambda **kw: tcd.sqrt_lasso(X, y, 2.8, options=cdo,
                                                  **kw),
        "scaled_lasso": lambda **kw: tcd.scaled_lasso(X, y, 0.4, options=io,
                                                      **kw),
        "feasible_lasso": lambda **kw: tcd.feasible_lasso(X, y, 0.4,
                                                          options=io, **kw),
        "sqrt_lasso_kkt_compensated":
            lambda **kw: tcd.sqrt_lasso_kkt_compensated(X32, y32, beta, 2.8,
                                                        **kw),
        "polish_sqrt_lasso": lambda **kw: tcd.polish_sqrt_lasso(
            X32, y32, beta, 2.8, max_rounds=1, **kw),
        "polish_scaled_lasso": lambda **kw: tcd.polish_scaled_lasso(
            X32, y32, beta, 0.4, max_sigma_rounds=1, max_rounds=1, **kw),
        "polish_feasible_lasso": lambda **kw: tcd.polish_feasible_lasso(
            X32, y32, beta, 0.4, max_loading_rounds=1, max_rounds=1, **kw),
        "coordinate_descent (wls)": lambda **kw: tcd.coordinate_descent(
            torch.zeros(P, dtype=torch.float64), tcd.WeightedLSLoss(
                torch.tensor(y), torch.tensor(X),
                torch.ones(N, dtype=torch.float64)), tcd.ProxL1(0.4), cdo,
            **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")


def test_scaled_lasso_compacting_matches_jax():
    """With the working set on, the σ rounds carry the working-set cache
    and take the secant start along the λ·σ abscissa, as in JAX."""
    rng, X, y = _data()
    lam = np.sqrt(2 * np.log(P) / N)
    io = cd.IterLassoOptions(
        options_cd=CDO.replace(block_size=8, compact=True, compact_size=16),
        init_procedure="init_std", opt_tol=1e-5)
    js = cd.scaled_lasso(X, y, lam, options=io)
    ts = tcd.scaled_lasso(X, y, lam, options=convert.iter_options_from_jax(io),
                          device="cpu")
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=1e-8)
    np.testing.assert_allclose(ts.penalty.lam0, float(js.penalty.lam0),
                               rtol=1e-10)
