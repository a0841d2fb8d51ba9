"""PyTorch port: profiling and checkpointing (``utils/profiling.py``,
``utils/checkpoint.py``, the engine's ``count_x``) against the JAX
package, on the cases of tests/test_observability.py at their shapes.

JAX and the port are compared in float64 with ``randomize=False``
(``jax.random`` orders cannot be reproduced); the resume cases compare
the port with itself, bit for bit, also with ``randomize=True`` and with
compaction forced.  Every port call passes ``device="cpu"``: the kernels'
plain twins run.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import coordinatedescent_jl_tpu as cd  # noqa: E402
import coordinatedescent_jl_tpu_torch as tcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.ops import block_cd  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils import host  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils import profiling as prof  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils.convert import (  # noqa: E402
    iter_options_from_jax, options_from_jax)

OPTS = cd.CDOptions(block_size=16, randomize=False)
T_OPTS = options_from_jax(OPTS)
CK_FIELDS = ("beta_warm", "residuals", "key", "c", "drift", "active",
             "ws_idx", "beta_prev", "lam_k", "lam_km1")


def _gen(n, p, s, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    beta[:s] = rng.standard_normal(s)
    y = X @ beta + 0.3 * rng.standard_normal(n)
    return X.astype(dtype), y.astype(dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _path(X, y, lams, f, opts, **kw):
    return tcd.lasso_path_resumable(X, y, lams, str(f), options=opts,
                                    device="cpu", **kw)


def _interrupt(f, lams):
    """Rewrite the checkpoint of a run over the first points as one of the
    whole grid, as an interrupted run leaves it."""
    ck = tcd.load_checkpoint(str(f))
    tcd.save_checkpoint(str(f), ck._replace(
        lam_path=np.asarray(lams, ck.lam_path.dtype)))
    return ck


def _same_checkpoints(f1, f2):
    c1, c2 = tcd.load_checkpoint(str(f1)), tcd.load_checkpoint(str(f2))
    for fld in CK_FIELDS + ("beta_path", "next_index", "ws_ok", "sigma"):
        assert np.array_equal(getattr(c1, fld), getattr(c2, fld)), fld


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------


def test_resumable_path_matches_jax_and_scan(tmp_path):
    X, y = _gen(100, 48, 6)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.05), 6))
    pj = cd.lasso_path_resumable(jnp.asarray(X), jnp.asarray(y), lams,
                                 str(tmp_path / "j.npz"), options=OPTS,
                                 standardize_X=False)
    pt = _path(X, y, lams, tmp_path / "t.npz", T_OPTS, standardize_X=False)
    ps = tcd.lasso_path(X, y, lams, options=T_OPTS, standardize_X=False,
                        path_batch=0, device="cpu")
    np.testing.assert_allclose(pt.beta_path.numpy(),
                               np.asarray(pj.beta_path), atol=1e-10)
    np.testing.assert_allclose(pt.beta_path.numpy(), ps.beta_path.numpy(),
                               atol=1e-10)
    ck = tcd.load_checkpoint(str(tmp_path / "t.npz"))
    assert ck.next_index == 6 and ck.key.dtype == np.uint8
    np.testing.assert_array_equal(ck.beta_path, pt.beta_path.numpy())


def test_resume_mid_path(tmp_path):
    X, y = _gen(100, 48, 6, seed=1)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.05), 6))
    f = tmp_path / "ck.npz"
    _path(X, y, lams[:3], f, T_OPTS, standardize_X=False)
    assert _interrupt(f, lams).next_index == 3
    p2 = _path(X, y, lams, f, T_OPTS, standardize_X=False)
    p1 = tcd.lasso_path(X, y, lams, options=T_OPTS, standardize_X=False,
                        device="cpu")
    np.testing.assert_allclose(p2.beta_path.numpy(), p1.beta_path.numpy(),
                               atol=1e-10)
    assert tcd.load_checkpoint(str(f)).next_index == 6


def test_resume_trajectory_identical_randomized(tmp_path):
    """The full state (generator, cached gradient, drift, active mask)
    persists, so an interrupted and resumed randomized run is bit for bit
    the uninterrupted one, checkpoint fields included."""
    X, y = _gen(100, 48, 6, seed=7)
    lams = np.exp(np.linspace(np.log(0.5), np.log(0.05), 6))
    opts = T_OPTS.replace(randomize=True)
    f1, f2 = tmp_path / "full.npz", tmp_path / "interrupted.npz"
    p_full = _path(X, y, lams, f1, opts, standardize_X=False, seed=3)
    _path(X, y, lams[:3], f2, opts, standardize_X=False, seed=3)
    assert _interrupt(f2, lams).next_index == 3
    p_res = _path(X, y, lams, f2, opts, standardize_X=False, seed=3)
    assert torch.equal(p_res.beta_path, p_full.beta_path)
    _same_checkpoints(f1, f2)


def test_checkpoint_ignored_for_different_grid(tmp_path):
    X, y = _gen(80, 32, 4, seed=2)
    f = tmp_path / "ck.npz"
    _path(X, y, [0.5, 0.2], f, T_OPTS, standardize_X=False)
    # a different λ grid restarts from scratch
    p = _path(X, y, [0.4, 0.1], f, T_OPTS, standardize_X=False)
    fresh = _path(X, y, [0.4, 0.1], tmp_path / "fresh.npz", T_OPTS,
                  standardize_X=False)
    assert p.beta_path.shape[0] == 2
    assert torch.equal(p.beta_path, fresh.beta_path)
    sol = tcd.lasso(X, y, 0.1, options=T_OPTS, device="cpu")
    np.testing.assert_allclose(p.beta_path[-1].numpy(), sol.x.numpy(),
                               atol=1e-6)


def test_checkpoint_old_format_ignored(tmp_path):
    """A file missing newer fields takes the ignore-and-restart path."""
    f = str(tmp_path / "old.npz")
    np.savez(f, lam_path=np.array([0.2, 0.1]), next_index=1,
             beta_path=np.zeros((1, 4)), beta_warm=np.zeros(4),
             residuals=np.zeros(8), sigma=1.0)
    assert tcd.load_checkpoint(f) is None
    X, y = _gen(40, 12, 1, seed=0)
    path = tcd.lasso_path_resumable(X, y, np.array([0.2, 0.1]), f,
                                    options=tcd.CDOptions(block_size=8),
                                    device="cpu")
    assert path.beta_path.shape == (2, 12)


def test_jax_checkpoint_restarts(tmp_path):
    """A checkpoint the JAX package wrote (a (2,) uint32 key) is no
    generator state: it loads as None and the port's run restarts."""
    X, y = _gen(80, 32, 4, seed=4)
    lams = [0.5, 0.2, 0.1]
    f = str(tmp_path / "jax.npz")
    cd.lasso_path_resumable(jnp.asarray(X), jnp.asarray(y), lams[:2], f,
                            options=OPTS, standardize_X=False)
    ck = cd.load_checkpoint(f)
    cd.save_checkpoint(f, ck._replace(lam_path=np.asarray(lams)))
    assert tcd.load_checkpoint(f) is None
    p = tcd.lasso_path_resumable(X, y, lams, f, options=T_OPTS,
                                 standardize_X=False, device="cpu")
    fresh = _path(X, y, lams, tmp_path / "fresh.npz", T_OPTS,
                  standardize_X=False)
    assert torch.equal(p.beta_path, fresh.beta_path)
    assert tcd.load_checkpoint(f).next_index == 3


def test_checkpoint_resume_trajectory_with_compaction(tmp_path):
    """Resume mid-path with compaction forced (f64): ws_idx rebuilds the
    working-set cache exactly, so the resumed run is bit for bit the
    uninterrupted one."""
    rng = np.random.default_rng(5)
    n, p = 100, 256
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    beta[rng.choice(p, 6, replace=False)] = rng.standard_normal(6)
    y = X @ beta + 0.2 * rng.standard_normal(n)
    lams = np.exp(np.linspace(np.log(0.4), np.log(0.05), 6))
    opts = tcd.CDOptions(block_size=8, compact=True, compact_size=64,
                         extrapolate=True, randomize=True, opt_tol=1e-9)
    f1, f2 = tmp_path / "full.npz", tmp_path / "inter.npz"
    full = _path(X, y, lams, f1, opts)
    _path(X, y, lams[:3], f2, opts)
    _interrupt(f2, lams)
    resumed = _path(X, y, lams, f2, opts)
    assert torch.equal(resumed.beta_path, full.beta_path)
    _same_checkpoints(f1, f2)


def test_resume_trajectory_identical_compaction(tmp_path):
    """Bitwise resume with compaction and the secant start engaged: the
    checkpoint's ws_idx, beta_prev, lam_k and lam_km1 restore the cache
    and the secant state; the port's scan follows the same trajectory."""
    X, y = _gen(120, 256, 8, seed=11)
    lam_max = float(np.abs(X.T @ y / 120).max())
    lams = lam_max * np.logspace(-0.3, -1.7, 8)
    opts = tcd.CDOptions(block_size=8, compact=True, compact_size=64,
                         extrapolate=True, randomize=True)
    f1, f2 = tmp_path / "full.npz", tmp_path / "interrupted.npz"
    p_full = _path(X, y, lams, f1, opts, standardize_X=False, seed=3,
                   checkpoint_every=3)
    _path(X, y, lams[:4], f2, opts, standardize_X=False, seed=3)
    _interrupt(f2, lams)
    p_res = _path(X, y, lams, f2, opts, standardize_X=False, seed=3,
                  checkpoint_every=3)
    assert torch.equal(p_res.beta_path, p_full.beta_path)
    _same_checkpoints(f1, f2)
    assert tcd.load_checkpoint(str(f1)).ws_idx.shape == (64,)
    p_scan = tcd.lasso_path(X, y, lams, options=opts, standardize_X=False,
                            seed=3, path_batch=0, device="cpu")
    assert torch.equal(p_scan.beta_path, p_full.beta_path)


def test_checkpoint_reads_per_save(tmp_path):
    """Each save reads the state to the host in two counted reads."""
    X, y = _gen(80, 32, 4, seed=2)
    lams = [0.5, 0.3, 0.2, 0.1]
    f = tmp_path / "ck.npz"
    host.reset()
    _path(X, y, lams, f, T_OPTS.replace(max_iter=0), standardize_X=False,
          checkpoint_every=2)
    assert host.COUNTS["host_reads"] == 2 * 2
    assert tcd.load_checkpoint(str(f)).next_index == 4


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


def _same_trace(tt, tj):
    """Same epochs and supports; max_h and the certificate within 1e-10
    relative, or absolutely within a few float64 ulps of the quantities
    they are differences of (steps of ~1e-9 between coordinates of order
    1: 1e-14; gaps between a primal and a dual of order 10: 1e-13), which
    two summation orders set apart."""
    assert len(tt.max_h) == len(tj.max_h)
    np.testing.assert_array_equal(tt.nnz, np.asarray(tj.nnz))
    np.testing.assert_allclose(tt.max_h, np.asarray(tj.max_h), rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(tt.certificate, np.asarray(tj.certificate),
                               rtol=1e-10, atol=1e-13)
    assert np.all(np.diff(tt.seconds) >= 0)


@pytest.mark.parametrize("loss", ["ls", "wls", "sqrt"])
def test_solve_with_trace_matches_jax(loss):
    X, y = {"ls": lambda: _gen(120, 64, 8, seed=3),
            "wls": lambda: _gen(120, 48, 5, seed=6),
            "sqrt": lambda: _gen(150, 64, 6, seed=5)}[loss]()
    lam = 1.1 * np.sqrt(2 * np.log(64)) if loss == "sqrt" else 0.1
    w = (0.3 + np.random.default_rng(7).random(X.shape[0])
         if loss == "wls" else None)
    bj, tj = cd.solve_with_trace(jnp.asarray(X), jnp.asarray(y), lam,
                                 options=OPTS, loss=loss,
                                 w=None if w is None else jnp.asarray(w))
    bt, tt = tcd.solve_with_trace(X, y, lam, options=T_OPTS, loss=loss,
                                  w=w, device="cpu")
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-10)
    _same_trace(tt, tj)
    assert tt.max_h[-1] < OPTS.opt_tol
    assert tt.duality_gap is tt.certificate
    assert tt.certificate[-1] < (5e-7 if loss == "sqrt" else 1e-6)


def test_scaled_lasso_with_trace_matches_jax():
    X, y = _gen(200, 80, 6, seed=8)
    lam = float(np.sqrt(2 * np.log(80) / 200))
    opts = cd.IterLassoOptions(options_cd=OPTS)
    sj, tj = cd.scaled_lasso_with_trace(jnp.asarray(X), jnp.asarray(y), lam,
                                        options=opts)
    st, tt = tcd.scaled_lasso_with_trace(
        X, y, lam, options=iter_options_from_jax(opts), device="cpu")
    ref = tcd.scaled_lasso(X, y, lam, options=iter_options_from_jax(opts),
                           device="cpu")
    assert len(tt.sigma) == len(tj.sigma)
    np.testing.assert_array_equal(tt.nnz, np.asarray(tj.nnz))
    assert _rel(tt.sigma, tj.sigma) <= 1e-10
    assert _rel(tt.rel_change, tj.rel_change) <= 1e-8
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), atol=1e-10)
    np.testing.assert_allclose(float(st.sigma), float(sj.sigma), rtol=1e-10)
    np.testing.assert_allclose(st.x.numpy(), ref.x.numpy(), atol=1e-10)
    assert tt.rel_change[-1] < opts.opt_tol
    np.testing.assert_allclose(tt.lam_eff, lam * tt.sigma, rtol=1e-12)
    assert tt.sigma.shape == tt.nnz.shape == tt.seconds.shape


def test_group_solve_with_trace_matches_jax():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((120, 32))
    b = np.zeros(32)
    b[:8] = rng.standard_normal(8)
    y = X @ b + 0.3 * rng.standard_normal(120)
    bj, tj = cd.group_solve_with_trace(jnp.asarray(X), jnp.asarray(y), 0.1,
                                       4, options=OPTS)
    bt, tt = tcd.group_solve_with_trace(X, y, 0.1, 4, options=T_OPTS,
                                        device="cpu")
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-10)
    _same_trace(tt, tj)
    sol = tcd.group_lasso(X, y, 0.1, 4, options=T_OPTS, device="cpu")
    np.testing.assert_allclose(bt.numpy(), sol.x.numpy(), atol=1e-7)
    assert tt.max_h[-1] < OPTS.opt_tol
    assert tt.certificate[-1] < 1e-8


# ---------------------------------------------------------------------------
# X-traffic accounting (count_x)
# ---------------------------------------------------------------------------


def _traffic_problem(dtype=np.float64):
    X, y = _gen(200, 512, 10, seed=3, dtype=dtype)
    lam = 0.1 * float(np.max(np.abs(X.T.astype(np.float64) @ y))
                      / X.shape[0])
    return X, y, lam


@pytest.mark.parametrize("opts", [
    OPTS,
    OPTS.replace(compact=True, compact_size=64),
    OPTS.replace(compact=True, compact_size=64, warm_start=False,
                 num_steps=5),
    OPTS.replace(use_pallas=False, opt_tol=1e-6),
    OPTS.replace(use_pallas=False, opt_tol=1e-6, warm_start=False,
                 num_steps=5),
], ids=["f64-warm", "f64-compact", "f64-cold", "f32-warm", "f32-cold"])
def test_solve_x_traffic_matches_jax(opts):
    """epochs, x_bytes, dense_equiv_bytes and nnz equal JAX's: in f64, and
    in f32 on the plain path at opt_tol 1e-6.  (At the f32 default 1e-7
    the solves end at the float32 floor, by the stall detector, where the
    two packages' sums round apart: 17 port epochs against JAX's 11 on
    this problem, the same counting rules.)"""
    dtype = np.float32 if opts.use_pallas is False else np.float64
    X, y, lam = _traffic_problem(dtype)
    rj = cd.solve_x_traffic(jnp.asarray(X), jnp.asarray(y), lam,
                            options=opts)
    rt = tcd.solve_x_traffic(X, y, lam, options=options_from_jax(opts),
                             device="cpu")
    assert (rt.epochs, rt.x_bytes, rt.dense_equiv_bytes, rt.nnz) == (
        rj.epochs, rj.x_bytes, rj.dense_equiv_bytes, rj.nnz)
    assert isinstance(rt.x_bytes, int) and rt.seconds > 0
    nb = -(-X.shape[1] // opts.block_size)
    assert rt.x_bytes >= nb * opts.block_size * X.shape[0] * X.itemsize


@pytest.mark.parametrize("warm", [True, False])
def test_count_x_leaves_the_solve_unchanged(warm):
    """count_x changes no bit of the solve and adds one host read (the
    dense passes' device accumulator, read at the end)."""
    X, y, lam = _traffic_problem()
    opts = T_OPTS.replace(compact=True, compact_size=64, warm_start=warm,
                          num_steps=4, randomize=True)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    prob = block_cd.build_blocked("ls", opts, torch.ones(X.shape[1],
                                                         dtype=Xt.dtype),
                                  X=Xt, y=yt)
    beta0 = torch.zeros_like(prob.lamw)
    out = []
    for count in (False, True):
        host.reset()
        res = block_cd.solve_blocked("ls", opts, prob, lam, beta0,
                                     torch.Generator().manual_seed(0),
                                     count_x=count)
        out.append((res[0] if count else res, dict(host.COUNTS)))
    (st0, c0), (st1, c1) = out
    assert torch.equal(st0.beta, st1.beta) and torch.equal(st0.r, st1.r)
    assert c0["epochs"] == c1["epochs"]
    assert c1["host_reads"] - c0["host_reads"] == 1
    with pytest.raises(ValueError, match="quad"):
        block_cd.solve_blocked("quad", opts, prob, lam, beta0, None,
                               count_x=True)


# ---------------------------------------------------------------------------
# NaN mode, timing, roofline, device rule
# ---------------------------------------------------------------------------


def test_debug_nans_context():
    from coordinatedescent_jl_tpu_torch.kernels import _build
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    with tcd.debug_nans(True):
        assert _build.NAN_CHECK
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0)) / torch.tensor(0.0)
        torch.empty(4)                # uninitialized memory is no result
        with tcd.debug_nans(False):
            assert torch.isnan(torch.log(torch.tensor(-1.0)))
        assert _build.NAN_CHECK
    assert not _build.NAN_CHECK
    assert _get_current_dispatch_mode() is None
    assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_debug_nans_clean_solve_and_kernel_twins():
    """A clean lasso passes inside the mode; a NaN in r makes the K5 and
    K1 twins raise."""
    from coordinatedescent_jl_tpu_torch.kernels import (active_pass,
                                                        gradient_sweep)

    X, y = _gen(60, 40, 4, seed=1)
    with tcd.debug_nans():
        sol = tcd.lasso(X, y, 0.1, options=T_OPTS, device="cpu")
    assert torch.isfinite(sol.x).all()
    prob = block_cd.build_blocked(
        "ls", T_OPTS, torch.ones(40, dtype=torch.float64),
        X=torch.as_tensor(X), y=torch.as_tensor(y))
    st = block_cd._init_state("ls", prob, torch.zeros_like(prob.lamw), None)
    r = st.r.clone()
    r[3] = float("nan")
    nb, B = prob.lamw.shape
    with tcd.debug_nans(), pytest.raises(FloatingPointError):
        gradient_sweep.fused_gradient_sweep(prob.Xwb, r)
    with tcd.debug_nans(), pytest.raises(FloatingPointError):
        active_pass.fused_active_pass(
            prob, st.beta, r, torch.ones(nb, dtype=torch.bool), 0.1, 60.0,
            torch.arange(nb), torch.arange(B), inner="ista")


def test_simple_timeit_returns_positive():
    assert tcd.simple_timeit(lambda: torch.ones((64, 64)).sum(), tries=2,
                             warmup=1) > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(str(tmp_path / "tr")):
        torch.ones((8, 8)).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


def test_measured_peak_hbm_sane():
    bw = prof.measured_peak_hbm(nbytes=1 << 22, chain=4, device="cpu")
    assert np.isfinite(bw) and bw > 0
    with pytest.raises(ValueError):
        prof.measured_peak_hbm(nbytes=1 << 22, chain=0, device="cpu")


def test_pass_roofline_multi_shares_build(monkeypatch):
    """One report per iters entry off one build, the byte count from K1's
    launch plan (keep_x: one read of each active block), the peak
    stubbed (its own path: test_measured_peak_hbm_sane)."""
    from coordinatedescent_jl_tpu_torch.kernels.active_pass import (
        SMEM_OPTIN_H100, plan_active_pass)

    monkeypatch.setattr(prof, "measured_peak_hbm", lambda *a, **k: 1e11)
    builds = []
    real = prof.build_blocked
    monkeypatch.setattr(prof, "build_blocked",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    reps = tcd.pass_roofline_multi(128, 256, block_size=16,
                                   iters_list=(4, 1), device="cpu")
    assert len(reps) == 2 and len(builds) == 1
    plan = plan_active_pass(128, 16, 4, 132, SMEM_OPTIN_H100)
    assert plan.keep_x
    nbytes = 16 * 128 * 16 * 4     # 16 blocks of (128, 16) float32, once
    assert reps[0].bytes_per_pass == reps[1].bytes_per_pass == nbytes
    assert reps[0].measured_peak_gbps == reps[1].measured_peak_gbps == 100.0
    for r in reps:
        assert np.isfinite(r.achieved_gbps) and r.achieved_gbps > 0
        assert r.seconds_per_pass > 0 and r.device_kind == "cpu"
        assert np.isnan(r.fraction_of_roofline)
    r1 = tcd.pass_roofline(128, 256, block_size=16, iters=2,
                           active_fraction=0.5, device="cpu")
    assert r1.bytes_per_pass == reps[0].bytes_per_pass // 2


@pytest.mark.parametrize("call", [
    lambda X, y, f: tcd.lasso_path_resumable(X, y, [0.1], f),
    lambda X, y, f: tcd.solve_with_trace(X, y, 0.1),
    lambda X, y, f: tcd.scaled_lasso_with_trace(X, y, 0.1),
    lambda X, y, f: tcd.group_solve_with_trace(X, y, 0.1, 4),
    lambda X, y, f: tcd.solve_x_traffic(X, y, 0.1),
    lambda X, y, f: tcd.pass_roofline(64, 64),
    lambda X, y, f: tcd.pass_roofline_multi(64, 64),
    lambda X, y, f: prof.measured_peak_hbm(1 << 20),
], ids=["resumable", "trace", "scaled_trace", "group_trace", "x_traffic",
        "roofline", "roofline_multi", "peak"])
def test_new_entry_points_need_a_gpu(call, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _gen(20, 8, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        call(X, y, str(tmp_path / "ck.npz"))
