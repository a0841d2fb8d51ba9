"""PyTorch port: the varying-coefficient suite against the JAX package (twins
of ``tests/test_varying_coefficient.py``).

Inputs come from a numpy seed and go to both packages in float64 on the
CPU, ``randomize=False`` (``jax.random`` orders cannot be reproduced), at
small shapes (n ≤ 120, p ≤ 10, grids ≤ 24 points, LOO-CV at n ≤ 40 with
two bandwidths).  Tolerances as the JAX suite's: ``locpolyl1`` β and
refits within 1e-7 at ``opt_tol=1e-10``; LOO-CV scores rtol 1e-8; the
dense linear algebra (kernels, expansion, ``locpoly``, interpolation,
standard errors) 1e-10 or tighter.
"""

import ast
import inspect
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import coordinatedescent_jl_tpu as cd  # noqa: E402
from coordinatedescent_jl_tpu.models import (  # noqa: E402
    varying_coefficient as jvc)

import coordinatedescent_jl_tpu_torch as tcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.models import (  # noqa: E402
    varying_coefficient as tvc)
from coordinatedescent_jl_tpu_torch.utils import convert, host  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils.helpers import (  # noqa: E402
    min_norm_lstsq)

CPU = {"device": "cpu"}
JOPTS = cd.CDOptions(opt_tol=1e-10, block_size=16, randomize=False)
TOPTS = convert.options_from_jax(JOPTS)
KERNELS = {"gauss": (cd.GaussianKernel, tcd.GaussianKernel),
           "epan": (cd.EpanechnikovKernel, tcd.EpanechnikovKernel)}


def gen_data(n, p, seed=0):
    """sin-varying coefficients (the JAX suite's generator)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.02, 0.98, size=n)
    X = rng.standard_normal((n, p))
    freqs = rng.choice([2, 4, 6, 8], size=p)
    y = (X * np.sin(freqs[None, :] * z[:, None])).sum(axis=1)
    return X, z, y + 0.3 * rng.standard_normal(n)


def bench_like(n, p, seed):
    """bench.py's varying-coefficient data at a small size."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0, 1, n)
    X = rng.standard_normal((n, p))
    y = np.sin(2 * np.pi * z) * X[:, 0] + 0.3 * rng.standard_normal(n)
    return X, z, y


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


# -- the module stands alone ---------------------------------------------------


def test_module_imports_no_jax():
    tree = ast.parse(inspect.getsource(tvc))
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names]
    names += [node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] == "jax"
                or m.split(".")[0] == "coordinatedescent_jl_tpu"], names


def test_exports_every_public_name_of_the_jax_module():
    public = ["GaussianKernel", "EpanechnikovKernel", "create_kernel",
              "evaluate", "expand_X", "expand_wX", "expand_Xt_w_X",
              "expand_Xt_w_Y", "locpoly", "locpolyl1", "refit_locpolyl1",
              "lvocv_locpolyl1", "lvocv_locpoly", "split_locpoly",
              "get_beta", "get_nonzero_coordinates", "sparse_coefficients",
              "get_residuals", "get_standard_error",
              "get_standard_error_hew"]
    for name in public:
        assert hasattr(jvc, name)
        assert getattr(tcd, name) is getattr(tvc, name)
        assert name in tcd.__all__


# -- kernels and expansion -----------------------------------------------------


@pytest.mark.parametrize("kind", list(KERNELS))
def test_kernels_match_jax(kind):
    jk, tk = KERNELS[kind]
    x = np.random.default_rng(4).standard_normal(50)
    for h in (0.3, 0.5):
        close(tvc.evaluate(tk(h), t(x), 0.4),
              jvc.evaluate(jk(h), jnp.asarray(x), 0.4), rtol=1e-14)
    assert tcd.create_kernel(tk, 0.2) == tk(0.2)
    assert convert.kernel_from_jax(jk(jnp.asarray(0.25))) == tk(0.25)


@pytest.mark.parametrize("degree", [0, 1, 2])
def test_expansion_matches_jax(degree):
    rng = np.random.default_rng(degree)
    n, p, z0 = 20, 3, 0.37
    X, z = rng.standard_normal((n, p)), rng.uniform(size=n)
    w, y = rng.uniform(0.1, 1.0, size=n), rng.standard_normal(n)
    ja = [jnp.asarray(a) for a in (w, X, z, y)]
    close(tvc.expand_X(t(X), t(z), z0, degree),
          jvc.expand_X(ja[1], ja[2], z0, degree), rtol=1e-14, atol=1e-15)
    close(tvc.expand_wX(t(w), t(X), t(z), z0, degree),
          jvc.expand_wX(*ja[:3], z0, degree), rtol=1e-14, atol=1e-15)
    close(tvc.expand_Xt_w_X(t(w), t(X), t(z), z0, degree),
          jvc.expand_Xt_w_X(*ja[:3], z0, degree), rtol=1e-12, atol=1e-14)
    close(tvc.expand_Xt_w_Y(t(w), t(X), t(z), t(y), z0, degree),
          jvc.expand_Xt_w_Y(*ja, z0, degree), rtol=1e-12, atol=1e-14)


def test_min_norm_lstsq_batched_matches_numpy():
    """The shared helper: a batch of matrices, one of them rank-deficient
    (a copied column) and one all zero, each at numpy's rank cut."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((3, 30, 6))
    A[1, :, 4] = A[1, :, 2]
    A[2] = 0.0
    b = rng.standard_normal((3, 30))
    got = min_norm_lstsq(t(A), t(b)).numpy()
    for i in range(3):
        close(got[i], np.linalg.lstsq(A[i], b[i], rcond=None)[0],
              atol=1e-12)
    assert abs(got[1, 4] - got[1, 2]) < 1e-12 and not got[2].any()


# -- locpoly -------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(KERNELS))
@pytest.mark.parametrize("degree", [0, 1, 2])
def test_locpoly_matches_jax(degree, kind):
    jk, tk = KERNELS[kind]
    X, z, y = gen_data(150, 3, seed=1)
    zgrid = np.linspace(0.05, 0.95, 7)
    out = tcd.locpoly(X, z, y, zgrid, degree, tk(0.3), **CPU)
    assert out.shape == (3 * (degree + 1), 7)
    close(out, jvc.locpoly(X, z, y, zgrid, degree, jk(0.3)), atol=1e-9)
    # a scalar point is a vector
    close(tcd.locpoly(X, z, y, 0.5, degree, tk(0.3), **CPU),
          jvc.locpoly(X, z, y, jnp.asarray(0.5), degree, jk(0.3)), atol=1e-9)


def test_locpoly_degenerate_point_falls_back_to_lstsq():
    """Zero kernel mass at z0 = 50 (compact kernel): the normal equations
    are singular, ``solve_ex`` returns non-finite numbers instead of
    raising, and the point is re-solved to the minimum-norm solution (all
    zeros) while the good point keeps its normal-equation fit."""
    rng = np.random.default_rng(3)
    n, p = 120, 4
    z = rng.uniform(0, 1, n)
    X = rng.standard_normal((n, p))
    y = X[:, 0] * np.sin(2 * np.pi * z) + 0.1 * rng.standard_normal(n)
    host.reset()
    out = tcd.locpoly(X, z, y, np.array([0.5, 50.0]), 1,
                      tcd.EpanechnikovKernel(0.1), **CPU).numpy()
    assert host.COUNTS["host_reads"] == 1
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out[:, 1], 0.0, atol=1e-12)
    close(out, jvc.locpoly(X, z, y, np.array([0.5, 50.0]), 1,
                           cd.EpanechnikovKernel(0.1)), atol=1e-10)
    out_s = tcd.locpoly(X, z, y, 50.0, 1, tcd.EpanechnikovKernel(0.1), **CPU)
    assert out_s.shape == (8,) and torch.all(out_s == 0)


def test_locpoly_near_singular_routes_to_lstsq(monkeypatch):
    """A near-singular float32 point (tiny kernel mass off the data): the
    whole grid must match the JAX package's rank-robust lstsq within 5e-3
    relative, as the JAX test holds it; and a point whose conditioning
    proxy is above 1e-3 (forced here: the CPU's float32 LU solves this
    one accurately) is the SVD solve's, the other the normal equations'."""
    rng = np.random.default_rng(3)
    n, p, degree = 60, 2, 1
    z = np.concatenate([rng.uniform(0.4, 0.6, n - 2),
                        np.array([0.9, 0.905])]).astype(np.float32)
    X = rng.standard_normal((n, p)).astype(np.float32)
    y = (X[:, 0] * np.sin(4 * z)
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    zgrid = np.array([0.5, 0.9], np.float32)
    kern = tcd.GaussianKernel(0.02)
    out = tcd.locpoly(X, z, y, zgrid, degree, kern, **CPU).numpy()
    for k, z0 in enumerate(zgrid):
        ref = np.asarray(jvc._locpoly_point_lstsq(
            jnp.asarray(X), jnp.asarray(z), jnp.asarray(y), jnp.asarray(z0),
            degree, cd.GaussianKernel(0.02)))
        denom = max(float(np.max(np.abs(ref))), 1e-6)
        assert np.max(np.abs(out[:, k] - ref)) / denom < 5e-3, (k, z0)

    normal = tvc._locpoly_normal

    def ill_conditioned_second(*a):
        coef, relres, info = normal(*a)
        return coef, relres * torch.tensor([1.0, 1e9]), info

    monkeypatch.setattr(tvc, "_locpoly_normal", ill_conditioned_second)
    routed = tcd.locpoly(X, z, y, zgrid, degree, kern, **CPU)
    k32 = tvc._in_dtype(kern, torch.float32)
    torch.testing.assert_close(routed[:, 1], tvc._locpoly_lstsq(
        t(X), t(z), t(y), t(zgrid[1:]), degree, k32)[0], rtol=0, atol=0)
    torch.testing.assert_close(routed[:, 0], normal(
        t(X), t(z), t(y), t(zgrid[:1]), degree, k32)[0][0], rtol=0, atol=0)


# -- locpolyl1 -----------------------------------------------------------------


@pytest.mark.parametrize("degree, kind, h", [(0, "gauss", 0.25),
                                             (1, "gauss", 0.25),
                                             (2, "epan", 0.4)])
def test_locpolyl1_scan_matches_jax(degree, kind, h):
    jk, tk = KERNELS[kind]
    X, z, y = gen_data(120, 10, seed=2)
    zgrid = np.linspace(0.2, 0.8, 6)
    jo, jr = cd.locpolyl1(X, z, y, zgrid, degree, jk(h), 0.05,
                          options=JOPTS, grid_batch=0)
    host.reset()
    to, tr = tcd.locpolyl1(X, z, y, zgrid, degree, tk(h), 0.05,
                           options=TOPTS, grid_batch=0, **CPU)
    assert to.shape == tr.shape == (10 * (degree + 1), 6)
    assert host.COUNTS["epochs"] > 0
    close(to, jo, atol=1e-7)
    close(tr, jr, atol=1e-7)
    assert (to != 0).any()
    # refits are exactly zero off the group support
    S = tcd.get_nonzero_coordinates(to[:, 3], 10, degree, True, **CPU)
    assert torch.all(tr[~S, 3] == 0)


def test_locpolyl1_matches_direct_weighted_lasso():
    """Each grid point is the weighted Lasso on the expanded design with
    the weighted loadings (the reference's ``locpolyl1_alt`` oracle),
    solved here by the port's ``coordinate_descent``."""
    X, z, y = gen_data(120, 10, seed=2)
    kern = tcd.GaussianKernel(0.25)
    out, _ = tcd.locpolyl1(X, z, y, [0.3, 0.7], 1, kern, 0.05,
                           refit=False, options=TOPTS, **CPU)
    for k, z0 in enumerate([0.3, 0.7]):
        w = tvc.evaluate(kern, t(z), z0)
        eX = tvc.expand_X(t(X), t(z), z0, 1)
        beta, _ = tcd.coordinate_descent(
            torch.zeros(20, dtype=torch.float64), tcd.WeightedLSLoss(
                t(y), eX, w), tcd.ProxL1(0.05, tcd.std_X(eX, w)),
            TOPTS, **CPU)
        close(out[:, k], beta, atol=1e-7)


@pytest.mark.parametrize("degree, kind, h", [(1, "gauss", 0.1),
                                             (2, "epan", 0.2)])
def test_locpolyl1_grid_batch_matches_scan_and_jax(degree, kind, h):
    """The batched grid (coarse anchors + chunked certify/refine, chunks of
    8 lanes with a short last one: 20 points, 4 anchors) certifies without falling back, with
    the JAX package's exact ``stats`` at float64, and reproduces the
    scan's β and refits and the JAX batched run's."""
    jk, tk = KERNELS[kind]
    X, z, y = bench_like(100, 8, seed=7)
    zg = np.linspace(0.05, 0.95, 20)
    opts = cd.CDOptions(opt_tol=1e-10, block_size=16, randomize=False)
    topts = convert.options_from_jax(opts)
    so, sr = tcd.locpolyl1(X, z, y, zg, degree, tk(h), 0.05, options=topts,
                           grid_batch=0, **CPU)
    st, jst = {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        bo, br = tcd.locpolyl1(X, z, y, zg, degree, tk(h), 0.05,
                               options=topts, grid_batch=8, coarse_stride=7,
                               stats=st, **CPU)
        jo, jr = cd.locpolyl1(X, z, y, zg, degree, jk(h), 0.05,
                              options=opts, grid_batch=8, coarse_stride=7,
                              stats=jst)
    # refine_rounds is the port's own count (tests/test_torch_spans.py)
    assert isinstance(st.pop("refine_rounds"), int)
    assert st == jst == {"used_batched": True, "batched_certified": True,
                         "stall_escaped_lanes": 0}
    close(bo, so, atol=1e-7)
    close(br, sr, atol=1e-7)
    close(bo, jo, atol=1e-7)
    close(br, jr, atol=1e-7)


def test_grid_batch_default_and_scan_chunk():
    """``grid_batch=None`` keeps the scan on the CPU (stats say so);
    ``scan_chunk`` is checked and otherwise changes nothing, bit for bit;
    the other arguments are checked as in the JAX package."""
    X, z, y = bench_like(60, 4, seed=11)
    zg = np.linspace(0.1, 0.9, 16)
    kern = tcd.GaussianKernel(0.15)
    st = {}
    o1, r1 = tcd.locpolyl1(X, z, y, zg, 1, kern, 0.05, options=TOPTS,
                           stats=st, **CPU)
    assert st == {"used_batched": False, "batched_certified": False,
                  "stall_escaped_lanes": 0, "refine_rounds": 0}
    for ch in (1, 5, 50):
        o2, r2 = tcd.locpolyl1(X, z, y, zg, 1, kern, 0.05, options=TOPTS,
                               scan_chunk=ch, **CPU)
        assert torch.equal(o1, o2) and torch.equal(r1, r2)
    for bad in ({"scan_chunk": 0}, {"grid_batch": -1},
                {"coarse_stride": 0}):
        with pytest.raises(ValueError):
            tcd.locpolyl1(X, z, y, zg, 1, kern, 0.05, options=TOPTS, **bad,
                          **CPU)


def test_refit_locpolyl1_matches_jax():
    X, z, y = gen_data(80, 5, seed=9)
    out, _ = tcd.locpolyl1(X, z, y, [0.5], 1, tcd.GaussianKernel(0.3),
                           0.05, refit=False, options=TOPTS, **CPU)
    beta = out[:, 0]
    br, S = tcd.refit_locpolyl1(X, z, y, 0.5, 1, tcd.GaussianKernel(0.3),
                                beta, **CPU)
    jbr, jS = cd.refit_locpolyl1(X, z, y, 0.5, 1, cd.GaussianKernel(0.3),
                                 beta.numpy())
    assert S.dtype == torch.bool and S.shape == (5,) and S.any()
    np.testing.assert_array_equal(S.numpy(), jS)
    assert br.shape == (int(S.sum()) * 2,)
    close(br, jbr, atol=1e-10)


def test_vc_batch_ops_products_match_einsum():
    """``_VcBatchOps``' two GEMM forms against the three-operand einsums
    they stand for."""
    X, z, y = bench_like(30, 4, seed=3)
    ops = tvc._VcBatchOps(t(X), t(z), t(y), tcd.GaussianKernel(0.2),
                          t([0.2, 0.5, 0.8]), 2, TOPTS)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal((3, 12)))
    ref = torch.einsum("kpd,np,knd->kn", u.reshape(3, 4, 3), t(X), ops.dpow)
    close(ops._pred(u), ref, rtol=1e-13)
    V = ops.dpow * ops.w[:, :, None]
    ref = torch.einsum("knd,np->kpd", V, t(X)).reshape(3, 12)
    close(ops._xt(V), ref, rtol=1e-13)


def _vc_round_state(dtype, degree, holdout, seed=5):
    """A chunk of 6 lanes of ``_VcBatchOps`` mid-refinement at n = 40, p =
    4, 5 FISTA steps a round and a stall patience of 2: random starts,
    lanes 1 and 4 certified (frozen), thresholds scaled by a per-lane σ (as
    the LOO-CV's λ·σ), the stall counters near the patience; for
    ``holdout`` each lane's own row at zero weight (the LOO-CV's lanes)."""
    X, z, y = bench_like(40, 4, seed)
    X, z, y = (t(a).to(dtype) for a in (X, z, y))
    k = 6
    idx = torch.arange(3, 3 + k) if holdout else None
    z0 = z[idx] if holdout else torch.linspace(0.1, 0.9, k, dtype=dtype)
    opts = TOPTS.replace(block_iters=5, stall_patience=2, opt_tol=1e-3)
    ops = tvc._VcBatchOps(X, z, y, tcd.GaussianKernel(0.2), z0, degree,
                          opts, holdout=idx)
    rng = np.random.default_rng(seed)
    sig = torch.as_tensor(0.5 + rng.random(k), dtype=dtype)
    thrw = ops.lamw * tvc._thr_scale(0.05, 40, dtype) * sig[:, None]
    B = torch.as_tensor(rng.standard_normal((k, ops.ep))
                        * (rng.random((k, ops.ep)) < 0.4), dtype=dtype)
    cert = torch.tensor([False, True, False, False, True, False])
    best = torch.as_tensor(rng.random(k), dtype=dtype)
    stall = torch.tensor([0, 3, 2, 1, 0, 2], dtype=torch.int32)
    esc = torch.tensor([False, False, True, False, False, False])
    return ops, (B, cert, best, stall, esc, thrw)


@pytest.mark.parametrize("holdout", [False, True])
@pytest.mark.parametrize("degree", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vc_round_plain_is_the_old_sequence(dtype, degree, holdout):
    """``_VcBatchOps.round_plain`` (and ``round`` and the kernel wrapper,
    which run it on the CPU) equals the sequence it gathers bit for bit:
    ``fista_phase``, the fresh residual, ``certify``'s per-lane max and
    ``stall_escape_update``; a certified lane's coefficients are ``(B ·
    sc) / sc``; the lanes' tensors are what the kernel takes."""
    from coordinatedescent_jl_tpu_torch.kernels import vc_round
    from coordinatedescent_jl_tpu_torch.ops.batched_certify import (
        stall_escape_update)

    ops, (B, cert, best, stall, esc, thrw) = _vc_round_state(dtype, degree,
                                                             holdout)
    # the kernel takes these as they are, at every degree
    vc_round.require_inputs(ops.X, ops.y, ops.w, ops.dpow, ops.sc, ops.Lt,
                            ops.adiag, ops.xwnorm, thrw, B, cert, best,
                            stall, esc)
    Bn = ops.fista_phase(B, cert, thrw)
    R = ops.residual(Bn)
    mx = torch.amax(ops.certify(Bn, R, thrw), dim=1)
    patience = 2 if dtype == torch.float32 else np.iinfo(np.int32).max
    want = (Bn, R, mx, *stall_escape_update(cert, best, stall, esc, mx,
                                            patience, 1e-3))
    for got in (ops.round_plain(B, cert, best, stall, esc, thrw),
                ops.round(B, cert, best, stall, esc, thrw),
                vc_round.fused_vc_round(ops, B, cert, best, stall, esc,
                                        thrw)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(Bn[cert], (B * ops.sc / ops.sc)[cert])
    assert not torch.equal(Bn[~cert], B[~cert])


@pytest.mark.parametrize("case", ["dtype", "shape", "device", "layout",
                                  "cert", "stall", "powers"])
def test_vc_round_require_inputs_rejects(case):
    """The kernel's input check refuses a dtype other than float32 /
    float64, a wrong shape, a tensor on another device, a non-contiguous
    tensor, a ``cert`` that is not bool, a ``stall`` that is not int32 and
    a ``B`` whose columns are not ``p·q1``."""
    from coordinatedescent_jl_tpu_torch.kernels import vc_round

    ops, (B, cert, best, stall, esc, thrw) = _vc_round_state(torch.float32,
                                                             1, False)
    t_ = {"X": ops.X, "y": ops.y, "w": ops.w, "dpow": ops.dpow,
          "sc": ops.sc, "Lt": ops.Lt, "adiag": ops.adiag,
          "xwnorm": ops.xwnorm, "thrw": thrw, "B": B, "cert": cert,
          "best": best, "stall": stall, "esc": esc}
    vc_round.require_inputs(**t_)
    if case == "dtype":
        t_ = {k: v.half() if v.is_floating_point() else v
              for k, v in t_.items()}
    elif case == "shape":
        t_["thrw"] = thrw[:, 1:].contiguous()
    elif case == "device":
        t_["y"] = ops.y.to("meta")
    elif case == "layout":
        t_["sc"] = ops.sc.T.contiguous().T
    elif case == "cert":
        t_["cert"] = cert.to(torch.uint8)
    elif case == "stall":
        t_["stall"] = stall.long()
    else:
        t_["dpow"] = ops.dpow[:, :, :1].contiguous()
    with pytest.raises(ValueError, match="vc-round kernel"):
        vc_round.require_inputs(**t_)


def test_vc_round_smem_bytes_pick_the_route():
    """``smem_bytes`` counts ``csrc/vc_round.cu::vc_layout``'s arrays (hand
    counts below), and ``pick_route`` takes route 0 exactly where its bytes
    fit the card's opt-in shared memory (232,448 bytes on an H100): the
    float32 varying-coefficient grid (n = 500, p = 50, degree 1) keeps X in
    shared memory, float64 reads it from L2."""
    from coordinatedescent_jl_tpu_torch.kernels import vc_round

    optin = 232_448
    assert vc_round.groups(500, 50) == 10
    assert vc_round.groups(3, 50) == 3 and vc_round.groups(10, 600) == 1
    # X 500 x 51, w and y 500 each, dpow and (w r) dpow 1,000 each, five
    # step vectors of 100, 10 x 100 partials, 32 slots
    f32 = 4 * (25_500 + 2 * 500 + 2 * 1_000 + 5 * 100 + 1_000 + 32)
    assert vc_round.smem_bytes(500, 50, 2, 4, 0) == f32 == 120_128
    assert vc_round.smem_bytes(500, 50, 2, 8, 0) == 2 * f32 > optin
    assert vc_round.smem_bytes(500, 50, 2, 8, 1) == 8 * (5 * 100 + 1_000
                                                         + 32)
    # every array rounded up to 16 bytes: 21 -> 24, 7 -> 8, 3 -> 4
    assert vc_round.smem_bytes(7, 3, 1, 4, 0) == 4 * (24 + 2 * 8 + 2 * 8
                                                      + 5 * 4 + 24 + 32)
    assert vc_round.pick_route(500, 50, 2, 4, optin) == 0
    assert vc_round.pick_route(500, 50, 2, 8, optin) == 1
    for n, p, q1, item in ((500, 50, 2, 4), (500, 50, 3, 4), (2000, 40, 2, 4),
                           (200, 50, 1, 8), (60, 700, 2, 4)):
        b0 = vc_round.smem_bytes(n, p, q1, item, 0)
        assert vc_round.pick_route(n, p, q1, item, b0) == 0
        assert vc_round.pick_route(n, p, q1, item, b0 - 1) == 1
        assert vc_round.pick_route(n, p, q1, item, optin) == int(b0 > optin)
        assert vc_round.smem_bytes(n, p, q1, item, 1) < b0


# -- bandwidth selection ---------------------------------------------------------


def test_lvocv_locpolyl1_sequential_and_batched_match_jax():
    """Sequential (``cv_batch=0``) and batched (``cv_batch=12``: chunks of
    12, 12 and 6 held-out lanes) against the JAX package's sequential
    score at rtol 1e-8, the ``stats`` contract exact at float64."""
    X, z, y = gen_data(30, 3, seed=7)
    hs = [0.3, 0.6]
    opts = cd.CDOptions(opt_tol=1e-10, block_size=8, randomize=False)
    topts = convert.options_from_jax(opts)
    want = np.asarray(cd.lvocv_locpolyl1(X, z, y, 1, hs, cd.GaussianKernel,
                                         0.1, options=opts, cv_batch=0))
    st = {}
    seq = tcd.lvocv_locpolyl1(X, z, y, 1, hs, tcd.GaussianKernel, 0.1,
                              options=topts, cv_batch=0, stats=st, **CPU)
    close(seq, want, rtol=1e-8)
    assert st == {"batched_certified": False, "stall_escaped_lanes": 0,
                  "lanes_resolved_sequentially": 0}
    st = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        bat = tcd.lvocv_locpolyl1(X, z, y, 1, hs, tcd.GaussianKernel, 0.1,
                                  options=topts, cv_batch=12, stats=st,
                                  **CPU)
    assert st == {"batched_certified": True, "stall_escaped_lanes": 0,
                  "lanes_resolved_sequentially": 0}
    close(bat, want, rtol=1e-8)


def test_lvocv_per_point_errors_match_jax():
    """The re-solve path for escaped lanes: per-row errors for a list of
    rows, against the JAX ``points=`` path, and their sum is the score."""
    X, z, y = gen_data(24, 3, seed=5)
    opts = cd.CDOptions(opt_tol=1e-11, block_size=8, randomize=False,
                        warm_start=True)
    topts = convert.options_from_jax(opts)
    pts = [0, 7, 23]
    import jax

    want = jvc._lvocv_locpolyl1_one_h(
        jnp.asarray(X), jnp.asarray(z), jnp.asarray(y), jnp.asarray(0.4),
        jnp.asarray(0.1), jax.random.PRNGKey(0), 0, cd.GaussianKernel, opts,
        points=jnp.asarray(pts))
    zt = t(z)
    got = tvc._lvocv_locpolyl1_one_h(t(X), zt, t(y), zt.tolist(), 0.4, 0.1,
                                     0, 0, tcd.GaussianKernel, topts,
                                     points=pts)
    close(got, want, rtol=1e-8)
    every = tvc._lvocv_locpolyl1_one_h(t(X), zt, t(y), zt.tolist(), 0.4,
                                       0.1, 0, 0, tcd.GaussianKernel, topts,
                                       points=list(range(24)))
    total = tvc._lvocv_locpolyl1_one_h(t(X), zt, t(y), zt.tolist(), 0.4,
                                       0.1, 0, 0, tcd.GaussianKernel, topts)
    close(torch.sum(every), total, rtol=1e-14)


@pytest.mark.parametrize("degree", [0, 1, 2])
def test_lvocv_locpoly_matches_jax(degree):
    X, z, y = gen_data(50, 2, seed=6)
    hs = [0.2, 0.4]
    close(tcd.lvocv_locpoly(X, z, y, degree, hs, tcd.GaussianKernel, **CPU),
          cd.lvocv_locpoly(X, z, y, degree, hs, cd.GaussianKernel),
          rtol=1e-10)


@pytest.mark.parametrize("kind", list(KERNELS))
def test_split_locpoly_matches_jax(kind):
    jk, tk = KERNELS[kind]
    X, z, y = gen_data(40, 4, seed=7)
    Xt, zt, yt = gen_data(30, 4, seed=8)
    zgrid = np.linspace(0.05, 0.95, 10)
    close(tcd.split_locpoly(X, z, y, Xt, zt, yt, zgrid, 1, [0.3, 0.5], tk,
                            **CPU),
          cd.split_locpoly(X, z, y, Xt, zt, yt, zgrid, 1, [0.3, 0.5], jk),
          rtol=1e-10)


# -- support, interpolation, standard errors -----------------------------------------


def test_get_beta_and_residuals_match_jax():
    zgrid = np.array([0.0, 0.5, 1.0])
    bg = np.array([[1.0, 2.0, 3.0], [0.0, 10.0, 20.0]])
    for z0 in (0.5, 0.25, -1.0, 2.0, 0.0, 1.0):
        close(tcd.get_beta(zgrid, bg, z0, **CPU),
              cd.get_beta(jnp.asarray(zgrid), jnp.asarray(bg), z0),
              rtol=1e-15)
    pts = np.array([0.5, 0.25, -1.0, 0.7])
    got = tcd.get_beta(zgrid, bg, pts, **CPU)
    assert got.shape == (2, 4)
    for k, z0 in enumerate(pts):
        close(got[:, k], cd.get_beta(jnp.asarray(zgrid), jnp.asarray(bg),
                                     z0), rtol=1e-15)
    X, z, y = gen_data(60, 2, seed=3)
    zg = np.linspace(0.02, 0.98, 25)
    bgrid = jvc.locpoly(X, z, y, zg, 1, cd.GaussianKernel(0.2))
    close(tcd.get_residuals(X, z, y, zg, np.asarray(bgrid), 1, **CPU),
          cd.get_residuals(X, z, y, zg, bgrid, 1), atol=1e-12)


def test_support_and_sparse_coefficients():
    p, degree = 4, 2
    beta = np.zeros(p * (degree + 1))
    beta[1], beta[6] = 1.0, -2.0
    for expanded in (False, True):
        np.testing.assert_array_equal(
            tcd.get_nonzero_coordinates(beta, p, degree, expanded,
                                        **CPU).numpy(),
            np.asarray(cd.get_nonzero_coordinates(beta, p, degree,
                                                  expanded)))
    rng = np.random.default_rng(0)
    dense = np.zeros((30, 7))
    dense[rng.choice(30, 5, replace=False), 2] = rng.standard_normal(5)
    dense[rng.choice(30, 3, replace=False), 5] = 1.0
    sp = tcd.sparse_coefficients(dense, **CPU)
    assert sp.is_sparse and sp._nnz() == np.count_nonzero(dense)
    np.testing.assert_array_equal(sp.to_dense().numpy(), dense)
    jsp = cd.sparse_coefficients(jnp.asarray(dense))
    np.testing.assert_array_equal(sp.to_dense().numpy(), jsp.todense())
    assert tcd.sparse_coefficients(dense, nse=16, **CPU)._nnz() == 8
    with pytest.raises(ValueError):
        tcd.sparse_coefficients(dense, nse=7, **CPU)


@pytest.mark.parametrize("degree", [0, 1])
def test_standard_errors_match_jax(degree):
    X, z, y = gen_data(100, 2, seed=5)
    kern = (cd.GaussianKernel(0.3), tcd.GaussianKernel(0.3))
    close(tcd.get_standard_error(X, z, 2.0, 0.5, degree, kern[1], **CPU),
          cd.get_standard_error(X, z, 2.0, 0.5, degree, kern[0]),
          rtol=1e-10)
    eps2 = np.random.default_rng(1).uniform(0.5, 1.5, size=100)
    close(tcd.get_standard_error_hew(X, z, eps2, 0.5, degree, kern[1],
                                     **CPU),
          cd.get_standard_error_hew(X, z, eps2, 0.5, degree, kern[0]),
          rtol=1e-10)


def test_entry_points_run_on_cuda_unless_cpu_is_asked(monkeypatch):
    """Without a usable CUDA device every entry point raises instead of
    running on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, z, y = gen_data(20, 2, seed=1)
    zg = np.array([0.3, 0.6])
    k = tcd.GaussianKernel(0.3)
    bg = np.zeros((4, 2))
    quick = tcd.CDOptions(block_size=4, randomize=False)
    calls = [
        lambda **kw: tcd.locpoly(X, z, y, zg, 1, k, **kw),
        lambda **kw: tcd.locpolyl1(X, z, y, zg, 1, k, 0.1, options=quick,
                                   **kw),
        lambda **kw: tcd.refit_locpolyl1(X, z, y, 0.5, 1, k, np.ones(4),
                                         **kw),
        lambda **kw: tcd.lvocv_locpolyl1(X, z, y, 1, [0.3],
                                         tcd.GaussianKernel, 0.1,
                                         options=quick, **kw),
        lambda **kw: tcd.lvocv_locpoly(X, z, y, 1, [0.3],
                                       tcd.GaussianKernel, **kw),
        lambda **kw: tcd.split_locpoly(X, z, y, X, z, y, zg, 1, [0.3],
                                       tcd.GaussianKernel, **kw),
        lambda **kw: tcd.get_beta(zg, bg, 0.4, **kw),
        lambda **kw: tcd.get_nonzero_coordinates(np.ones(4), 2, 1, True,
                                                 **kw),
        lambda **kw: tcd.sparse_coefficients(bg, **kw),
        lambda **kw: tcd.get_residuals(X, z, y, zg, bg, 1, **kw),
        lambda **kw: tcd.get_standard_error(X, z, 1.0, 0.5, 1, k, **kw),
        lambda **kw: tcd.get_standard_error_hew(X, z, np.ones(20), 0.5, 1,
                                                k, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")
