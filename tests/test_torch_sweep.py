"""PyTorch port: the restricted gradient sweep's plain twin and the
gradient refresh (``_refresh_c``) against the JAX package.

The JAX sweep runs in Pallas interpret mode at a tiny shape (n = 100, not a
multiple of the row chunk; B = 16).
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

from coordinatedescent_jl_tpu_torch.kernels import (  # noqa: E402
    gradient_sweep as tgs)
from coordinatedescent_jl_tpu_torch.ops import block_cd as tbcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils import convert  # noqa: E402

N, P, B = 100, 150, 16


def _setup(dtype, seed=31):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, P)).astype(dtype)
    y = rng.standard_normal(N).astype(dtype)
    prob = jbcd.build_blocked("ls", cd.CDOptions(block_size=B),
                              jnp.ones((P,), dtype), X=jnp.asarray(X),
                              y=jnp.asarray(y))
    nb = prob.lamw.shape[0]
    r = rng.standard_normal(N).astype(dtype)
    c_prev = rng.standard_normal((nb, B)).astype(dtype)
    need = rng.random(nb) < 0.4
    need[0] = True
    return prob, r, c_prev, need


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sweep_twin_matches_jax(dtype):
    """f64 at 1e-12; f32 at 1e-4 on |c| ~ 10 (sums of 100 products added
    in different orders)."""
    prob, r, c_prev, need = _setup(dtype)
    ref = jpb.restricted_gradient_sweep(prob.Xwb, jnp.asarray(r),
                                        jnp.asarray(need),
                                        jnp.asarray(c_prev), interpret=True)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tprob = convert.problem_from_jax(prob, dtype=tdt)
    out = tgs.restricted_gradient_sweep(tprob.Xwb, torch.as_tensor(r),
                                        torch.as_tensor(need),
                                        torch.as_tensor(c_prev))
    tol = 1e-12 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol)
    np.testing.assert_array_equal(out.numpy()[~need], c_prev[~need])


def test_dense_products_do_not_copy_the_design():
    """The dense refresh and X·β run straight off the (nb, n, B) layout:
    ``torch.einsum`` copied the whole blocked design on every call (4 GB
    at the bench shape: 0.86 s of a 1.16 s device time per 100-point path
    on an NVIDIA H100 80GB HBM3 at 700 W)."""
    from torch.profiler import ProfilerActivity, profile

    Xb = torch.randn(6, 50, 16, dtype=torch.float64)
    r = torch.randn(50, dtype=torch.float64)
    beta = torch.randn(6, 16, dtype=torch.float64)
    prob = tbcd.BlockedProblem(Xb=Xb, Xwb=Xb, y=r, q=None, adiag=None,
                               lamw=None, valid=None, xwnorm=None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c = tbcd._full_gradient_c("ls", prob, r, kernels=False)
        xb = tbcd._blocks_matvec(Xb, beta)
    names = {e.key for e in prof.key_averages()}
    assert not names & {"aten::clone", "aten::copy_", "aten::contiguous"}
    np.testing.assert_allclose(c.numpy(),
                               np.einsum("bnk,n->bk", Xb.numpy(), r.numpy()),
                               atol=1e-12)
    np.testing.assert_allclose(
        xb.numpy(), np.einsum("bnk,bk->n", Xb.numpy(), beta.numpy()),
        atol=1e-12)


@pytest.mark.parametrize("frac", [0.3, 0.9, 1.0])
def test_refresh_c_matches_jax(frac):
    """Both sides of the engine's dense switch (the restricted sweep below
    every block, the dense sweep at every block) and of the JAX package's
    0.8 switch give the JAX refresh."""
    prob, r, c_prev, _ = _setup(np.float64, seed=7)
    nb = prob.lamw.shape[0]
    need = np.arange(nb) < int(round(frac * nb))
    st = jbcd._init_state("ls", prob, jnp.zeros((nb, B)),
                          jax.random.PRNGKey(0))
    st = st._replace(r=jnp.asarray(r), c=jnp.asarray(c_prev))
    ref = jbcd._refresh_c("ls", prob, st, jnp.asarray(need), "on", True)
    tprob = convert.problem_from_jax(prob)
    tst = convert.state_from_jax(st)
    out = tbcd._refresh_c("ls", tprob, tst, torch.as_tensor(need),
                          int(need.sum()), True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dense_sweep_twin_matches_jax(dtype):
    """K5's plain twin against JAX ``fused_gradient_sweep`` in Pallas
    interpret mode (n = 100, not a multiple of its row chunk; B = 16):
    f64 rtol 1e-12, f32 rtol 1e-5 (plus that much of max|c| for entries
    that cancel)."""
    prob, r, _, _ = _setup(dtype)
    ref = np.asarray(jpb.fused_gradient_sweep(prob.Xwb, jnp.asarray(r),
                                              interpret=True))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tprob = convert.problem_from_jax(prob, dtype=tdt)
    rt = torch.as_tensor(r)
    out = tgs.fused_gradient_sweep_plain(tprob.Xwb, rt)
    rtol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(out.numpy(), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())
    # the wrapper takes the twin for CPU tensors, and so does the engine's
    # dense refresh with the kernels on
    np.testing.assert_array_equal(
        tgs.fused_gradient_sweep(tprob.Xwb, rt).numpy(), out.numpy())
    np.testing.assert_array_equal(
        tbcd._full_gradient_c("ls", tprob, rt, kernels=True).numpy(),
        out.numpy())


@pytest.mark.parametrize("form", ["f32", "f64"])
def test_loadings_wrappers_take_the_plain_twin_on_the_cpu(form):
    """On CPU tensors the loadings wrappers run their plain twins (the same
    bits) and count no launch: the blocked float32 form
    (``loadings_sweep``: 20 blocks of 16 columns, over more than one step
    of 16 blocks, the padded columns 0) and the dense float64 form
    (``loadings_f64_sweep``: float32 X, float64 weights, chunks of 64
    columns with a ragged tail), each ``Σ_i w_i x_ij²`` against numpy in
    float64 (float32 1e-5, float64 1e-12 relative)."""
    rng = np.random.default_rng(12)
    n, p = N, 310
    X = rng.standard_normal((n, p)).astype(np.float32)
    e = rng.standard_normal(n)
    n0 = tgs.LAUNCHES_LOADINGS
    if form == "f32":
        nb = -(-p // 16)
        Xp = np.zeros((n, nb * 16), np.float32)
        Xp[:, :p] = X
        Xb = torch.as_tensor(Xp.reshape(n, nb, 16).transpose(1, 0, 2).copy())
        w = torch.as_tensor(e.astype(np.float32)) ** 2
        got = tgs.loadings_sweep(Xb, w)
        assert torch.equal(got, tgs.loadings_sweep_plain(Xb, w))
        assert got.shape == (nb, 16) and got.dtype == torch.float32
        assert not got.reshape(-1)[p:].any()
        got, tol = got.reshape(-1)[:p], 1e-5
        wn = w.numpy().astype(np.float64)
    else:
        w = torch.as_tensor(e) ** 2
        got = tgs.loadings_f64_sweep(torch.as_tensor(X), w, col_chunk=64)
        assert torch.equal(got, tgs.loadings_f64_sweep_plain(
            torch.as_tensor(X), w, 64))
        assert got.dtype == torch.float64
        tol, wn = 1e-12, w.numpy()
    want = wn @ X.astype(np.float64) ** 2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol)
    assert tgs.LAUNCHES_LOADINGS == n0
