"""PyTorch port: the wls, sqrt and quad kinds of the block engine against
the JAX package: the plain twin of the fused-pass kernel, the engine's
passes and checks on a converted mid-solve state, the kernel gates of the
full check, and ``coordinate_descent`` with every loss.

Inputs come from a numpy seed and go to both packages; ``randomize=False``
(``jax.random`` orders cannot be reproduced).  The JAX fused pass runs in
Pallas interpret mode at a tiny shape (n = 90, B = 16, row chunk 32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import coordinatedescent_jl_tpu as cd  # noqa: E402
from coordinatedescent_jl_tpu.ops import block_cd as jbcd  # noqa: E402
from coordinatedescent_jl_tpu.ops import pallas_block as jpb  # noqa: E402

import coordinatedescent_jl_tpu_torch as tcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.kernels import (  # noqa: E402
    active_pass as tap)
from coordinatedescent_jl_tpu_torch.kernels import check as tcheck  # noqa: E402
from coordinatedescent_jl_tpu_torch.ops import block_cd as tbcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils import convert  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils.options import CDOptions  # noqa: E402

import oracle  # noqa: E402

N, P, B, R = 90, 64, 16, 32
KINDS = ["wls", "sqrt", "quad"]


def _data(seed, n=N, p=P):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    beta[:7] = rng.standard_normal(7)
    y = X @ beta + 0.3 * rng.standard_normal(n)
    w = 0.5 + rng.random(n)
    return rng, X, y, w


def _lam(kind):
    """A penalty level that leaves a sparse, non-empty solution."""
    return {"wls": 0.05, "ls": 0.05, "sqrt": 0.25, "quad": 4.0}[kind]


def _build(kind, dtype, gram=True, seed=41, opts=None):
    """The same blocked problem and a sparse state in both packages."""
    rng, X, y, w = _data(seed)
    opts = opts or cd.CDOptions(block_size=B, randomize=False)
    lamw = jnp.asarray((0.5 + rng.random(P)).astype(dtype))
    if kind == "quad":
        A = (X.T @ X / N + 0.1 * np.eye(P)).astype(dtype)
        q = (-(X.T @ y) / N).astype(dtype)
        prob = jbcd.build_blocked("quad", opts, lamw, A=jnp.asarray(A),
                                  q=jnp.asarray(q))
    else:
        prob = jbcd.build_blocked(
            kind, opts, lamw, X=jnp.asarray(X.astype(dtype)),
            y=jnp.asarray(y.astype(dtype)), w=jnp.asarray(w.astype(dtype)))
        if not gram:
            prob = prob._replace(Kb=None)
    nb = prob.lamw.shape[0]
    beta_b = (0.3 * rng.standard_normal((nb, B))
              * (rng.random((nb, B)) < 0.3)).astype(dtype)
    beta_b = jnp.asarray(beta_b) * prob.valid
    beta_b = beta_b.at[2].set(0.0)                  # one inactive block
    st = jbcd._init_state(kind, prob, beta_b, jax.random.PRNGKey(0))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    return (prob, st, convert.problem_from_jax(prob, dtype=tdt),
            convert.state_from_jax(st, dtype=tdt), opts)


def _nsc(kind):
    return 1.0 if kind == "quad" else float(N)


def _mid_solve(kind, seed=7, opts=None):
    """A state after one full check and one active pass of the JAX engine:
    cached gradients, a drift and (sqrt) a running ``‖r‖²``."""
    prob, st, tprob, _, opts = _build(kind, np.float64, seed=seed, opts=opts)
    lam0, nsc = jnp.asarray(_lam(kind)), jnp.asarray(_nsc(kind))
    st, _ = jbcd._full_check(kind, prob, st, lam0, nsc, opts.opt_tol, opts)
    st, _ = jbcd._active_pass(kind, prob, st, lam0, nsc, False, opts)
    return prob, st, tprob, convert.state_from_jax(st), opts


def _assert_state(tst, st, tol=1e-10):
    np.testing.assert_allclose(tst.beta.numpy(), np.asarray(st.beta), atol=tol)
    np.testing.assert_allclose(tst.r.numpy(), np.asarray(st.r), atol=tol)
    np.testing.assert_allclose(float(tst.rsqr), float(st.rsqr), rtol=tol,
                               atol=tol)
    np.testing.assert_array_equal(tst.active.numpy(), np.asarray(st.active))
    np.testing.assert_allclose(tst.c.numpy(), np.asarray(st.c), atol=tol)
    np.testing.assert_allclose(tst.drift.numpy(), np.asarray(st.drift),
                               rtol=tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("gram", [False, True])
@pytest.mark.parametrize("inner", ["exact", "ista"])
@pytest.mark.parametrize("kind", ["wls", "sqrt"])
def test_active_pass_twin_kinds_match_jax_chunked(kind, inner, gram, dtype):
    """Plain twin of the fused-pass kernel vs the JAX chunked Pallas pass for
    the wls and sqrt kinds over inner × Gram: β, r, maxh and rsqr.  f64:
    1e-10; f32: the two add in different orders and FISTA carries the
    rounding through 16 iterations, 2e-5 on O(1) coefficients.  rsqr is
    relative: rebuilt from r (ista) it is held to the same 2e-5; carried
    through the exact scan in f32 it goes through 64 three-term updates
    that each cancel against ‖r‖², on gradients that already differ in the
    last bits: 2e-4."""
    prob, st, tprob, tst, _ = _build(kind, dtype, gram)
    nb = prob.lamw.shape[0]
    lam0 = _lam(kind)
    order, n_active = jpb._prefetch_order(st.active, jnp.arange(nb))
    nr = -(-N // R)
    r_pad = jnp.pad(st.r, (0, nr * R - N)).reshape(1, nr * R)
    rsqr0 = jnp.dot(st.r, st.r)
    b3, r3, mh3, rs3 = jpb._chunked_pass(
        prob.Xb, prob.Xwb, prob.Kb, prob.lamw, st.beta, r_pad, rsqr0,
        order, n_active.reshape(1), jnp.arange(B, dtype=jnp.int32),
        jnp.asarray(lam0, dtype), jnp.asarray(float(N), dtype), n=N, B=B,
        nb=nb, R=R, kind=kind, inner=inner, iters=16, retain=True,
        interpret=True)
    bt, rt, mht, rst = tap.fused_active_pass(
        tprob, tst.beta, tst.r, tst.active, lam0, float(N), torch.arange(nb),
        torch.arange(B), kind=kind, rsqr=torch.dot(tst.r, tst.r),
        inner=inner, iters=16)
    tol = 1e-10 if dtype == np.float64 else 2e-5
    np.testing.assert_allclose(bt.numpy(), np.asarray(b3), atol=tol)
    np.testing.assert_allclose(rt.numpy(), np.asarray(r3).reshape(-1)[:N],
                               atol=10 * tol)
    np.testing.assert_allclose(float(mht), float(mh3), atol=tol)
    rtol = 2e-4 if (dtype, kind, inner) == (np.float32, "sqrt", "exact") \
        else tol
    np.testing.assert_allclose(float(rst), float(rs3), rtol=rtol, atol=tol)
    if kind == "sqrt":
        # the pass moved something, and rsqr follows the new residual
        assert float(mht) > 0
        np.testing.assert_allclose(float(rst), float(torch.dot(rt, rt)),
                                   rtol=1e-9 if dtype == np.float64 else 1e-3)


@pytest.mark.parametrize("kind", ["wls", "sqrt"])
def test_active_pass_twin_no_active_block_keeps_rsqr(kind):
    """With zero active blocks the pass returns its inputs, rsqr too."""
    _, _, tprob, tst, _ = _build(kind, np.float64)
    nb = tprob.lamw.shape[0]
    rs0 = torch.tensor(3.25, dtype=torch.float64)
    bt, rt, mht, rst = tap.fused_active_pass(
        tprob, tst.beta, tst.r, torch.zeros(nb, dtype=torch.bool), 0.1,
        float(N), torch.arange(nb), torch.arange(B), kind=kind, rsqr=rs0,
        inner="ista")
    assert torch.equal(bt, tst.beta) and torch.equal(rt, tst.r)
    assert float(mht) == 0.0 and float(rst) == 3.25


def test_active_pass_twin_rejects_unknown_kind():
    _, _, tprob, tst, _ = _build("sqrt", np.float64)
    nb = tprob.lamw.shape[0]
    with pytest.raises(ValueError):
        tap.fused_active_pass(tprob, tst.beta, tst.r, tst.active, 0.1,
                              float(N), torch.arange(nb), torch.arange(B),
                              kind="quad")


@pytest.mark.parametrize("kind", KINDS)
def test_init_state_and_lambda_max_match_jax(kind):
    prob, st, tprob, _, _ = _build(kind, np.float64)
    tst = tbcd._init_state(kind, tprob, torch.tensor(np.asarray(st.beta)),
                           None)
    np.testing.assert_allclose(tst.r.numpy(), np.asarray(st.r), atol=1e-10)
    np.testing.assert_allclose(float(tst.rsqr), float(st.rsqr), rtol=1e-10)
    np.testing.assert_array_equal(tst.active.numpy(), np.asarray(st.active))
    lm = jbcd._lambda_max(kind, prob, st, jnp.asarray(_nsc(kind)))
    tlm = tbcd._lambda_max(kind, tprob, tst, _nsc(kind), False)
    np.testing.assert_allclose(float(tlm), float(lm), rtol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
def test_build_blocked_matches_jax(kind):
    rng, X, y, w = _data(9)
    opts = cd.CDOptions(block_size=B, cache_gram=True)
    topts = convert.options_from_jax(opts)
    lamw = 0.5 + rng.random(P - 3)
    if kind == "quad":
        A = X[:, :P - 3].T @ X[:, :P - 3] / N
        q = -(X[:, :P - 3].T @ y) / N
        jp = jbcd.build_blocked("quad", opts, jnp.asarray(lamw),
                                A=jnp.asarray(A), q=jnp.asarray(q))
        tp = tbcd.build_blocked("quad", topts, torch.tensor(lamw),
                                A=torch.tensor(A), q=torch.tensor(q))
    else:
        jp = jbcd.build_blocked(kind, opts, jnp.asarray(lamw),
                                X=jnp.asarray(X[:, :P - 3]), y=jnp.asarray(y),
                                w=jnp.asarray(w))
        tp = tbcd.build_blocked(kind, topts, torch.tensor(lamw),
                                X=torch.tensor(X[:, :P - 3]),
                                y=torch.tensor(y), w=torch.tensor(w))
    for name in ("Xb", "Xwb", "q", "adiag", "lamw", "xwnorm", "Kb"):
        a, b = getattr(tp, name), getattr(jp, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12,
                                       err_msg=name)
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    assert (tp.Xwb is tp.Xb) == (kind == "sqrt")


@pytest.mark.parametrize("kind", KINDS)
def test_xla_active_pass_kinds_match_jax(kind):
    prob, st, tprob, tst, _ = _mid_solve(kind)
    nb = prob.lamw.shape[0]
    lam0, nsc = _lam(kind), _nsc(kind)
    st2, mh = jbcd._xla_active_pass(kind, prob, st, jnp.asarray(lam0),
                                    jnp.asarray(nsc), jnp.arange(nb),
                                    jnp.arange(B), st.key)
    tst2, tmh = tbcd._xla_active_pass(kind, tprob, tst, lam0, nsc,
                                      torch.arange(nb), torch.arange(B))
    _assert_state(tst2, st2)
    np.testing.assert_allclose(float(tmh), float(mh), atol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
def test_full_check_kinds_match_jax(kind):
    prob, st, tprob, tst, opts = _mid_solve(kind)
    lam0, nsc = _lam(kind), _nsc(kind)
    st2, mh = jbcd._full_check(kind, prob, st, jnp.asarray(lam0),
                               jnp.asarray(nsc), opts.opt_tol, opts)
    tst2, tmh = tbcd._full_check(kind, tprob, tst, lam0, nsc, opts.opt_tol,
                                 convert.options_from_jax(opts))
    _assert_state(tst2, st2)
    np.testing.assert_allclose(float(tmh), float(mh), atol=1e-10)
    if kind == "sqrt":       # the exact ‖r‖² refresh
        np.testing.assert_allclose(float(tst2.rsqr),
                                   float(torch.dot(tst.r, tst.r)), rtol=1e-14)


@pytest.mark.parametrize("kind", ["wls", "sqrt"])
def test_stale_certified_kinds_match_jax(kind):
    """A converged state whose gradients went stale by a small drift on
    some blocks and a large one on the others: masks equal, and some but
    not all blocks certify."""
    prob, st, tprob, _, opts = _build(kind, np.float64)
    opts = opts.replace(opt_tol=1e-9, max_iter=4000)
    # sqrt certifies all-zero blocks only: a level that leaves some
    lam0, nsc = (3.0 if kind == "sqrt" else _lam(kind)), _nsc(kind)
    st = jbcd._solve_at_lambda(kind, opts, prob, jnp.asarray(lam0), st,
                               jnp.asarray(nsc))
    nb = prob.lamw.shape[0]
    st = st._replace(drift=jnp.asarray([1e-12, 10.0] * (nb // 2)))
    tst = convert.state_from_jax(st)
    cert, bound = jbcd._stale_certified(kind, prob, st, st.rsqr,
                                        jnp.asarray(lam0), jnp.asarray(nsc),
                                        1e-6)
    tcert, tbound = tbcd._stale_certified(kind, tprob, tst, tst.rsqr, lam0,
                                          nsc, 1e-6)
    np.testing.assert_array_equal(tcert.numpy(), np.asarray(cert))
    np.testing.assert_allclose(tbound.numpy(), np.asarray(bound), atol=1e-10)
    assert bool(tcert.any()) and not bool(tcert.all())


@pytest.mark.parametrize("kind", ["wls", "sqrt"])
def test_compact_pass_kinds_match_jax(kind):
    """One working-set round of the wls and sqrt kinds: the gather holds the
    weighted columns too, the Gram is built from them, rsqr goes in and
    out of the inner solve."""
    rng = np.random.default_rng(12)
    n, p, Bc = 80, 256, 16
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    beta[[3, 70, 200]] = [1.5, -2.0, 1.0]
    y = X @ beta + 0.2 * rng.standard_normal(n)
    w = 0.5 + rng.random(n)
    opts = cd.CDOptions(block_size=Bc, compact=True, compact_size=32,
                        randomize=False)
    prob = jbcd.build_blocked(kind, opts, jnp.ones(p), X=jnp.asarray(X),
                              y=jnp.asarray(y), w=jnp.asarray(w))
    nb = prob.lamw.shape[0]
    st = jbcd._init_state(kind, prob, jnp.zeros((nb, Bc)),
                          jax.random.PRNGKey(0))
    lam = 0.1 if kind == "wls" else 0.5
    lam0, nsc = jnp.asarray(lam), jnp.asarray(float(n))
    st, _ = jbcd._full_check(kind, prob, st, lam0, nsc, opts.opt_tol, opts)
    nc = jbcd._compact_mode(kind, opts, prob, jnp.float64)
    cache = jbcd._empty_ws_cache(kind, prob, nc, opts)
    st2, _, cache2 = jbcd._compact_pass(kind, prob, st, lam0, nsc, opts, nc,
                                        cache)
    tprob = convert.problem_from_jax(prob)
    topts = convert.options_from_jax(opts)
    tcache = tbcd._empty_ws_cache(kind, tprob, nc, topts)
    assert (tcache.Xwb is None) == (kind != "wls")
    tst2, tmh, tcache2 = tbcd._compact_pass(
        kind, tprob, convert.state_from_jax(st), lam, float(n), topts, nc,
        tcache)
    assert tmh == 0.0 and bool(torch.any(tst2.beta != 0))
    np.testing.assert_array_equal(tcache2.idx.numpy(), np.asarray(cache2.idx))
    np.testing.assert_allclose(tcache2.Kb.numpy(), np.asarray(cache2.Kb),
                               atol=1e-10)
    if kind == "wls":
        np.testing.assert_allclose(tcache2.Xwb.numpy(),
                                   np.asarray(cache2.Xwb), atol=1e-12)
    np.testing.assert_allclose(tst2.beta.numpy(), np.asarray(st2.beta),
                               atol=1e-10)
    np.testing.assert_allclose(tst2.r.numpy(), np.asarray(st2.r), atol=1e-10)
    np.testing.assert_allclose(float(tst2.rsqr), float(st2.rsqr), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(tst2.drift.numpy(), np.asarray(st2.drift),
                               rtol=1e-10)


class _OnCudaOpts(CDOptions):
    pass


@pytest.mark.parametrize("kind", ["ls", "wls", "sqrt", "quad"])
def test_full_check_kernel_gates(kind, monkeypatch):
    """With the kernels on (f32), a sqrt or quad full check never reaches
    the check kernels' wrappers; an ls check reaches them with the screen
    on and a wls check with the screen off."""
    _, _, tprob, tst, _ = _build(kind, np.float32)
    calls = []

    def phase_a(*args, screen):
        calls.append(screen)
        return tcheck.check_phase_a_plain(*args, screen=screen)

    monkeypatch.setattr(tbcd, "use_kernels", lambda opts, t: True)
    monkeypatch.setattr(tcheck, "check_phase_a", phase_a)
    monkeypatch.setattr(tcheck, "check_phase_b", tcheck.check_phase_b_plain)
    # the gradient refresh would launch K2/K5: keep it on the plain product
    monkeypatch.setattr(
        tbcd, "_refresh_c",
        lambda kind, prob, st, need, n_need, kernels: torch.where(
            need[:, None],
            tbcd._full_gradient_c(kind, prob, st.r, False), st.c))
    st2, mh = tbcd._full_check(kind, tprob, tst, _lam(kind), _nsc(kind), 1e-6,
                               CDOptions(block_size=B))
    assert calls == {"ls": [True], "wls": [False]}.get(kind, [])
    assert float(mh) > 0 and st2.c.shape == tst.c.shape


@pytest.mark.parametrize("kind", ["wls", "sqrt", "quad"])
def test_screen_is_off_for_every_kind_but_ls(kind, monkeypatch):
    """The gap-safe screen is the least-squares Lasso's: the plain check of
    another kind never evaluates it, whatever ``opts.screen`` says."""
    _, _, tprob, tst, _ = _build(kind, np.float64)

    def boom(*a, **k):
        raise AssertionError("the gap-safe screen ran")

    monkeypatch.setattr(tbcd, "_gap_safe_candidates", boom)
    tbcd._full_check(kind, tprob, tst, _lam(kind), _nsc(kind), 1e-8,
                     CDOptions(block_size=B, screen=True))


@pytest.mark.parametrize("kind", ["sqrt", "quad"])
def test_solve_never_calls_check_kernels(kind, monkeypatch):
    """A whole sqrt or quad solve with the kernel gate forced open never
    calls the check kernels' wrappers (the active pass stays plain)."""
    rng, X, y, w = _data(3)

    def boom(*a, **k):
        raise AssertionError("a check kernel's wrapper was called")

    monkeypatch.setattr(tcheck, "check_phase_a", boom)
    monkeypatch.setattr(tcheck, "check_phase_b", boom)
    opts = CDOptions(block_size=B, randomize=False, opt_tol=1e-5)
    X32, y32 = torch.tensor(X, dtype=torch.float32), torch.tensor(
        y, dtype=torch.float32)
    if kind == "quad":
        loss = tcd.QuadraticLoss(X32.T @ X32 / N, -(X32.T @ y32) / N)
        lam = 0.5
    else:
        loss = tcd.SqrtLassoLoss(y32, X32)
        lam = 2.0
    beta, _ = tcd.coordinate_descent(torch.zeros(P), loss, tcd.ProxL1(lam),
                                     opts, device="cpu")
    assert 0 < int((beta != 0).sum()) < P


def _jax_loss(kind, X, y, w):
    if kind == "ls":
        return cd.LeastSquaresLoss(jnp.asarray(y), jnp.asarray(X))
    if kind == "wls":
        return cd.WeightedLSLoss(jnp.asarray(y), jnp.asarray(X),
                                 jnp.asarray(w))
    if kind == "sqrt":
        return cd.SqrtLassoLoss(jnp.asarray(y), jnp.asarray(X))
    n = X.shape[0]
    return cd.QuadraticLoss(jnp.asarray(X.T @ X / n),
                            jnp.asarray(-(X.T @ y) / n))


def _torch_loss(kind, X, y, w):
    X, y, w = torch.tensor(X), torch.tensor(y), torch.tensor(w)
    if kind == "ls":
        return tcd.LeastSquaresLoss(y, X)
    if kind == "wls":
        return tcd.WeightedLSLoss(y, X, w)
    if kind == "sqrt":
        return tcd.SqrtLassoLoss(y, X)
    n = X.shape[0]
    return tcd.QuadraticLoss(X.T @ X / n, -(X.T @ y) / n)


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_coordinate_descent_kinds_match_jax_and_oracle(kind, warm):
    """``coordinate_descent`` with the weighted, sqrt and quadratic losses
    (weighted L1; warm and with the λ-continuation) vs the JAX package and
    the NumPy oracle: 1e-8 on β."""
    rng, X, y, w = _data(21, n=60, p=40)
    lamw = 0.5 + rng.random(40)
    lam = {"wls": 0.1, "sqrt": 1.2, "quad": 0.1}[kind]
    kw = dict(block_size=8, randomize=False, opt_tol=1e-11, warm_start=warm,
              num_steps=5, max_iter=5000)
    jb, jr = cd.coordinate_descent(
        jnp.zeros(40), _jax_loss(kind, X, y, w),
        cd.ProxL1(jnp.asarray(lam), jnp.asarray(lamw)), cd.CDOptions(**kw))
    tb, tr = tcd.coordinate_descent(
        torch.zeros(40, dtype=torch.float64), _torch_loss(kind, X, y, w),
        tcd.ProxL1(lam, torch.tensor(lamw)), CDOptions(**kw), device="cpu")
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-8)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-8)
    if kind == "wls":
        ob, _ = oracle.cd_lasso(X, y, lam, lamw, w)
    elif kind == "sqrt":
        ob, _ = oracle.cd_sqrt_lasso(X, y, lam, lamw)
    else:
        ob, _ = oracle.cd_quadratic(X.T @ X / 60, -(X.T @ y) / 60, lam, lamw)
    assert 0 < int((tb != 0).sum()) < 40
    np.testing.assert_allclose(tb.numpy(), ob, atol=1e-8)


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("kind", ["ls", "wls", "quad"])
def test_coordinate_descent_prox_zero_matches_jax(kind, warm):
    """``ProxZero``: one unpenalized solve from ``beta0`` (warm) or from
    zero, never the λ-continuation; n > p so the minimizer is unique."""
    rng, X, y, w = _data(5, n=60, p=12)
    beta0 = 0.1 * rng.standard_normal(12)
    kw = dict(block_size=4, randomize=False, opt_tol=1e-12, warm_start=warm,
              max_iter=20000)
    jb, _ = cd.coordinate_descent(jnp.asarray(beta0),
                                  _jax_loss(kind, X, y, w), cd.ProxZero(),
                                  cd.CDOptions(**kw))
    tb, _ = tcd.coordinate_descent(torch.tensor(beta0),
                                   _torch_loss(kind, X, y, w), tcd.ProxZero(),
                                   CDOptions(**kw), device="cpu")
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-8)
    if kind != "wls":
        np.testing.assert_allclose(
            tb.numpy(), np.linalg.lstsq(X, y, rcond=None)[0], atol=1e-7)


def test_coordinate_descent_input_checks():
    rng, X, y, w = _data(1, n=30, p=10)
    Xt, yt = torch.tensor(X), torch.tensor(y)
    with pytest.raises(ValueError):        # row weights of the wrong length
        tcd.coordinate_descent(torch.zeros(10, dtype=torch.float64),
                               tcd.WeightedLSLoss(yt, Xt, torch.ones(7)),
                               tcd.ProxL1(0.1), device="cpu")
    with pytest.raises(ValueError):        # penalty weights of the wrong length
        tcd.coordinate_descent(torch.zeros(10, dtype=torch.float64),
                               tcd.SqrtLassoLoss(yt, Xt),
                               tcd.ProxL1(0.1, torch.ones(9)), device="cpu")
    with pytest.raises(ValueError):        # beta0 against the loss
        tcd.coordinate_descent(torch.zeros(11, dtype=torch.float64),
                               tcd.QuadraticLoss(Xt.T @ Xt, Xt.T @ yt),
                               tcd.ProxL1(0.1), device="cpu")


@pytest.mark.parametrize("kind", ["ls", "wls", "sqrt", "quad"])
def test_loss_value_and_gradient_match_jax(kind):
    from coordinatedescent_jl_tpu.ops import losses as jl
    from coordinatedescent_jl_tpu_torch.ops import losses as tl

    rng, X, y, w = _data(8, n=30, p=10)
    beta = rng.standard_normal(10)
    jloss, tloss = _jax_loss(kind, X, y, w), _torch_loss(kind, X, y, w)
    assert tloss.kind == jloss.kind == kind
    assert tl.num_coordinates(tloss) == jl.num_coordinates(jloss) == 10
    np.testing.assert_allclose(float(tl.value(tloss, torch.tensor(beta))),
                               float(jl.value(jloss, jnp.asarray(beta))),
                               rtol=1e-12)
    np.testing.assert_allclose(tl.gradient(tloss, torch.tensor(beta)).numpy(),
                               np.asarray(jl.gradient(jloss,
                                                      jnp.asarray(beta))),
                               atol=1e-12)


def test_package_exports_gradient_and_value():
    """``gradient`` and ``value`` are in the package's exports, as in the
    JAX package's."""
    from coordinatedescent_jl_tpu_torch import gradient, value
    from coordinatedescent_jl_tpu_torch.ops import losses as tl

    assert gradient is tl.gradient and value is tl.value
    assert {"gradient", "value"} <= set(tcd.__all__)
