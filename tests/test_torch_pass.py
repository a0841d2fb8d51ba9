"""PyTorch port: the active pass (plain twin of the fused-pass kernel and
the plain exact-scan pass) against the JAX package, plus the mode rule and
the import boundary.

Inputs come from a numpy seed; the JAX problem and state carry across
through ``utils/convert.py``.  The JAX fused pass runs in Pallas interpret
mode at a tiny shape (n = 90, B = 16, row chunk 32: a ragged tail).
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import coordinatedescent_jl_tpu as cd  # noqa: E402
from coordinatedescent_jl_tpu.ops import block_cd as jbcd  # noqa: E402
from coordinatedescent_jl_tpu.ops import pallas_block as jpb  # noqa: E402

from coordinatedescent_jl_tpu_torch.kernels import (  # noqa: E402
    active_pass as tap)
from coordinatedescent_jl_tpu_torch.ops import block_cd as tbcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils import convert  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils.options import (  # noqa: E402
    CDOptions, use_kernels)

N, P, B, R = 90, 64, 16, 32


def _setup(dtype, gram, seed=41):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, P))
    beta = np.zeros(P)
    beta[:7] = rng.standard_normal(7)
    y = X @ beta + 0.3 * rng.standard_normal(N)
    opts = cd.CDOptions(block_size=B, randomize=False)
    lamw = jnp.asarray((0.5 + rng.random(P)).astype(dtype))
    prob = jbcd.build_blocked("ls", opts, lamw, X=jnp.asarray(X.astype(dtype)),
                              y=jnp.asarray(y.astype(dtype)))
    if not gram:
        prob = prob._replace(Kb=None)
    nb = prob.lamw.shape[0]
    beta_b = (rng.standard_normal((nb, B))
              * (rng.random((nb, B)) < 0.3)).astype(dtype)
    beta_b = jnp.asarray(beta_b) * prob.valid
    beta_b = beta_b.at[2].set(0.0)                  # one inactive block
    st = jbcd._init_state("ls", prob, beta_b, jax.random.PRNGKey(0))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    return (prob, st, convert.problem_from_jax(prob, dtype=tdt),
            convert.state_from_jax(st, dtype=tdt))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("gram", [False, True])
@pytest.mark.parametrize("inner", ["exact", "ista"])
def test_active_pass_twin_matches_jax_chunked(inner, gram, dtype):
    """Plain twin of the fused-pass kernel vs the JAX chunked Pallas pass
    (the main-path variant) over inner × Gram.  f64: 1e-12 as the JAX
    tests use; f32: the two add in different orders, and FISTA carries
    the rounding through 16 iterations — 2e-5 on O(1) coefficients."""
    prob, st, tprob, tst = _setup(dtype, gram)
    nb = prob.lamw.shape[0]
    lam0, nsc = 0.05, float(N)
    order, n_active = jpb._prefetch_order(st.active, jnp.arange(nb))
    nr = -(-N // R)
    r_pad = jnp.pad(st.r, (0, nr * R - N)).reshape(1, nr * R)
    b3, r3, mh3, _ = jpb._chunked_pass(
        prob.Xb, prob.Xwb, prob.Kb, prob.lamw, st.beta, r_pad, st.rsqr,
        order, n_active.reshape(1), jnp.arange(B, dtype=jnp.int32),
        jnp.asarray(lam0, dtype), jnp.asarray(nsc, dtype), n=N, B=B, nb=nb,
        R=R, kind="ls", inner=inner, iters=16, retain=True, interpret=True)
    bt, rt, mht, _ = tap.fused_active_pass(
        tprob, tst.beta, tst.r, tst.active, lam0, nsc, torch.arange(nb),
        torch.arange(B), kind="ls", inner=inner, iters=16)
    tol = 1e-12 if dtype == np.float64 else 2e-5
    np.testing.assert_allclose(bt.numpy(), np.asarray(b3), atol=tol)
    np.testing.assert_allclose(rt.numpy(), np.asarray(r3).reshape(-1)[:N],
                               atol=10 * tol)
    np.testing.assert_allclose(float(mht), float(mh3), atol=tol)


@pytest.mark.parametrize("gram", [False, True])
def test_xla_active_pass_matches_jax(gram):
    prob, st, tprob, tst = _setup(np.float64, gram, seed=3)
    nb = prob.lamw.shape[0]
    st2, mh = jbcd._xla_active_pass("ls", prob, st, jnp.asarray(0.05),
                                    jnp.asarray(float(N)), jnp.arange(nb),
                                    jnp.arange(B), st.key)
    tst2, tmh = tbcd._xla_active_pass("ls", tprob, tst, 0.05, float(N),
                                      torch.arange(nb), torch.arange(B))
    np.testing.assert_allclose(tst2.beta.numpy(), np.asarray(st2.beta),
                               atol=1e-12)
    np.testing.assert_allclose(tst2.r.numpy(), np.asarray(st2.r), atol=1e-12)
    np.testing.assert_array_equal(tst2.active.numpy(), np.asarray(st2.active))
    np.testing.assert_allclose(float(tmh), float(mh), atol=1e-12)


def test_active_pass_drift_matches_jax():
    """``_active_pass`` adds ‖Δr‖ to every block's drift, as in JAX."""
    prob, st, tprob, tst = _setup(np.float64, True, seed=5)
    st2, _ = jbcd._active_pass("ls", prob, st, jnp.asarray(0.05),
                               jnp.asarray(float(N)), randomize=False)
    tst2, _ = tbcd._active_pass("ls", tprob, tst, 0.05, float(N),
                                randomize=False)
    np.testing.assert_allclose(tst2.drift.numpy(), np.asarray(st2.drift),
                               rtol=1e-12)


@pytest.mark.parametrize("reuse", [False, True])
def test_compact_pass_matches_jax(reuse):
    """One working-set round from the same state: a fresh gather (empty
    cache), or the second round of a solve, whose carried cache still
    covers the support and violators (reused, no gather); the cache
    carries across through ``ws_cache_from_jax``."""
    rng = np.random.default_rng(12)
    n, p, Bc = 80, 256, 16
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    beta[[3, 70, 200]] = [1.5, -2.0, 1.0]
    y = X @ beta + 0.2 * rng.standard_normal(n)
    opts = cd.CDOptions(block_size=Bc, compact=True, compact_size=32,
                        randomize=False)
    prob = jbcd.build_blocked("ls", opts, jnp.ones(p), X=jnp.asarray(X),
                              y=jnp.asarray(y))
    nb = prob.lamw.shape[0]
    st = jbcd._init_state("ls", prob, jnp.zeros((nb, Bc)),
                          jax.random.PRNGKey(0))
    lam0, nsc = jnp.asarray(0.1), jnp.asarray(float(n))
    st, _ = jbcd._full_check("ls", prob, st, lam0, nsc, opts.opt_tol, opts)
    nc = jbcd._compact_mode("ls", opts, prob, jnp.float64)
    cache = jbcd._empty_ws_cache("ls", prob, nc, opts)
    if reuse:
        st, _, cache = jbcd._compact_pass("ls", prob, st, lam0, nsc, opts,
                                          nc, cache)
        st, _ = jbcd._full_check("ls", prob, st, lam0, nsc, opts.opt_tol,
                                 opts)
    st2, _, cache2 = jbcd._compact_pass("ls", prob, st, lam0, nsc, opts, nc,
                                        cache)
    tcache = convert.ws_cache_from_jax(cache)
    tst2, tmh, tcache2 = tbcd._compact_pass(
        "ls", convert.problem_from_jax(prob), convert.state_from_jax(st),
        0.1, float(n), convert.options_from_jax(opts), nc, tcache)
    assert tmh == 0.0
    if reuse:                                       # covered: no regather
        np.testing.assert_array_equal(np.asarray(cache2.idx),
                                      np.asarray(cache.idx))
        assert tcache2.Xb is tcache.Xb
    np.testing.assert_array_equal(tcache2.idx.numpy(), np.asarray(cache2.idx))
    np.testing.assert_allclose(tst2.beta.numpy(), np.asarray(st2.beta),
                               atol=1e-10)
    np.testing.assert_allclose(tst2.r.numpy(), np.asarray(st2.r), atol=1e-10)
    np.testing.assert_allclose(tst2.drift.numpy(), np.asarray(st2.drift),
                               rtol=1e-10)


def test_prefetch_order_matches_jax():
    rng = np.random.default_rng(0)
    active = rng.random(11) < 0.4
    border = rng.permutation(11)
    o, na = jpb._prefetch_order(jnp.asarray(active), jnp.asarray(border))
    to, tna = tap._prefetch_order(torch.as_tensor(active),
                                  torch.as_tensor(border))
    np.testing.assert_array_equal(to.numpy(), np.asarray(o))
    assert int(tna) == int(na)


class _OnCuda:
    is_cuda = True


def test_mode_rule():
    """Kernels iff the tensors are on CUDA and the option allows them."""
    cpu = torch.zeros(1)
    assert use_kernels(CDOptions(), _OnCuda())
    assert use_kernels(CDOptions(use_pallas=True), _OnCuda())
    assert not use_kernels(CDOptions(use_pallas=False), _OnCuda())
    assert not use_kernels(CDOptions(), cpu)
    assert not use_kernels(CDOptions(use_pallas=False), cpu)
    with pytest.raises(ValueError):
        use_kernels(CDOptions(use_pallas=True), cpu)


def test_use_pallas_true_on_cpu_raises():
    from coordinatedescent_jl_tpu_torch import lasso

    X = torch.randn(20, 40, dtype=torch.float64)
    with pytest.raises(ValueError):
        lasso(X, torch.randn(20, dtype=torch.float64), 0.1,
              options=CDOptions(block_size=16, use_pallas=True),
              device="cpu")


def test_import_leaves_jax_out():
    code = ("import sys, coordinatedescent_jl_tpu_torch, "
            "coordinatedescent_jl_tpu_torch.kernels.check, "
            "coordinatedescent_jl_tpu_torch.kernels.active_pass, "
            "coordinatedescent_jl_tpu_torch.kernels.gradient_sweep, "
            "coordinatedescent_jl_tpu_torch.utils.convert, "
            "coordinatedescent_jl_tpu_torch.ops.batched_certify, "
            "coordinatedescent_jl_tpu_torch.ops.compensated, "
            "coordinatedescent_jl_tpu_torch.models.polish, "
            "coordinatedescent_jl_tpu_torch.profile_paths; "
            "assert 'jax' not in sys.modules; "
            "assert 'triton' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
