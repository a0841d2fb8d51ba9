"""PyTorch port: the feature-sharded engine, its estimators, the sharded
group and symmetric drivers and the scenario batches
(``coordinatedescent_jl_tpu_torch/parallel``) against the JAX package's
``parallel`` on the same mesh shape, on the cases of tests/test_parallel.py.

The JAX functions run on a mesh of the first D devices of conftest's
8-device CPU mesh; the port's run in a Gloo world of D spawned ranks on
the CPU (one world per D for the whole module, every case a call made by
``torch_rank_calls.run_calls``).  Same numpy inputs, float64,
``randomize=False`` (``jax.random`` orders cannot be reproduced); β,
residuals and σ within 1e-9 absolute (``rtol=0``) of the JAX sharded
result, the LOO-CV scores within 1e-9 relative, and every rank's result
identical (the results are replicated).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import coordinatedescent_jl_tpu as cd  # noqa: E402
import coordinatedescent_jl_tpu.parallel as jpar  # noqa: E402
import coordinatedescent_jl_tpu_torch as tcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils.convert import (  # noqa: E402
    iter_options_from_jax, options_from_jax)
from torch_parity import ATOL, Cases, gen as _gen  # noqa: E402

OPTS = cd.CDOptions(block_size=16, randomize=False, opt_tol=1e-10)
T_OPTS = options_from_jax(OPTS)


def _gen_group(n, ng, G, s_groups, seed=0, sigma=0.3):
    rng = np.random.default_rng(seed)
    p = ng * G
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    for g in rng.choice(ng, s_groups, replace=False):
        beta[g * G:(g + 1) * G] = rng.standard_normal(G)
    return X, X @ beta + sigma * rng.standard_normal(n)


FEAT = {D: ((D,), ("feature",)) for D in (2, 3, 4)}
C = Cases()
case = C.add


# ---- the feature-sharded engine -----------------------------------------

X1, y1 = _gen(120, 100, 10)
case("lasso", 2, FEAT[2],
     [("parallel.lasso_sharded", (X1, y1, 0.1), {"options": T_OPTS})],
     lambda m: [jpar.lasso_sharded(X1, y1, 0.1, m, options=OPTS)],
     ("x", "residuals", "sigma"))

X2, y2 = _gen(90, 37, 5, seed=3)
case("lasso_uneven_p", 3, FEAT[3],
     [("parallel.lasso_sharded", (X2, y2, 0.15), {"options": T_OPTS})],
     lambda m: [jpar.lasso_sharded(X2, y2, 0.15, m, options=OPTS)],
     ("x", "residuals"))

X3, y3 = _gen(80, 64, 6, seed=1)
LAMW3 = 0.5 + np.random.default_rng(11).random(64)
case("weighted_cd", 4, FEAT[4],
     [("parallel.coordinate_descent_sharded",
       (np.zeros(64), tcd.LeastSquaresLoss(y3, X3), tcd.ProxL1(0.08, LAMW3)),
       {"options": T_OPTS})],
     lambda m: [jpar.coordinate_descent_sharded(
         jnp.zeros(64), cd.LeastSquaresLoss(jnp.asarray(y3), jnp.asarray(X3)),
         cd.ProxL1(0.08, jnp.asarray(LAMW3)), m, OPTS)],
     (0, 1))

X4, y4 = _gen(100, 48, 6, seed=5)
O4 = OPTS.replace(warm_start=False, num_steps=20)
case("cold_continuation", 2, FEAT[2],
     [("parallel.lasso_sharded", (X4, y4, 0.05),
       {"options": options_from_jax(O4)})],
     lambda m: [jpar.lasso_sharded(X4, y4, 0.05, m, options=O4)],
     ("x", "residuals"))

X5, y5 = _gen(100, 64, 6, seed=7)
case("sqrt_lasso", 2, FEAT[2],
     [("parallel.sqrt_lasso_sharded", (X5, y5, 0.3 / np.sqrt(100)),
       {"options": T_OPTS})],
     lambda m: [jpar.sqrt_lasso_sharded(X5, y5, 0.3 / np.sqrt(100), m,
                                        options=OPTS)],
     ("x", "residuals"))

# the wls and sqrt kinds with compaction forced: the shards' working-set
# rounds and the union round in those kinds
X5w, y5w = _gen(120, 128, 6, seed=37)
W5 = 0.5 + np.random.default_rng(39).random(120)
O5c = cd.CDOptions(block_size=8, compact=True, compact_size=32,
                   opt_tol=1e-10, randomize=False)
LAM5s = 0.3 * float(np.max(np.abs(y5w @ X5w)) / np.linalg.norm(y5w))
case("wls_and_sqrt_compact", 2, FEAT[2],
     [("parallel.coordinate_descent_sharded",
       (np.zeros(128), tcd.WeightedLSLoss(y5w, X5w, W5), tcd.ProxL1(0.05)),
       {"options": options_from_jax(O5c)}),
      ("parallel.coordinate_descent_sharded",
       (np.zeros(128), tcd.SqrtLassoLoss(y5w, X5w), tcd.ProxL1(LAM5s)),
       {"options": options_from_jax(O5c)})],
     lambda m: [jpar.coordinate_descent_sharded(
         jnp.zeros(128), cd.WeightedLSLoss(jnp.asarray(y5w), jnp.asarray(X5w),
                                           jnp.asarray(W5)),
         cd.ProxL1(0.05), m, O5c),
         jpar.coordinate_descent_sharded(
         jnp.zeros(128), cd.SqrtLassoLoss(jnp.asarray(y5w), jnp.asarray(X5w)),
         cd.ProxL1(LAM5s), m, O5c)],
     (0, 1))

X6, y6 = _gen(150, 64, 8, seed=9, sigma=0.5)
LAM6 = np.sqrt(2 * np.log(64) / 150)
IO6 = cd.IterLassoOptions(options_cd=OPTS)


def _check_scaled(port, ref):
    for pt, jx in zip(port, ref):
        for f in ("x", "residuals", "sigma"):
            np.testing.assert_allclose(pt[f], jx[f], rtol=0, atol=ATOL,
                                       err_msg=f)
        np.testing.assert_allclose(pt["penalty"]["lam0"],
                                   jx["penalty"]["lam0"], rtol=1e-12)


case("scaled_lasso", 2, FEAT[2],
     [("parallel.scaled_lasso_sharded", (X6, y6, LAM6),
       {"options": iter_options_from_jax(IO6)})],
     lambda m: [jpar.scaled_lasso_sharded(X6, y6, LAM6, m, options=IO6)],
     check=_check_scaled)

rng7 = np.random.default_rng(51)
X7 = rng7.standard_normal((120, 512))
b7 = np.zeros(512)
b7[rng7.choice(512, 10, replace=False)] = rng7.standard_normal(10)
y7 = X7 @ b7 + 0.2 * rng7.standard_normal(120)
O7 = cd.CDOptions(block_size=8, compact=True, compact_size=32, opt_tol=1e-10,
                  randomize=False)
case("compaction", 4, FEAT[4],
     [("parallel.lasso_sharded", (X7, y7, 0.15),
       {"options": options_from_jax(O7)}),
      ("parallel.lasso_sharded", (X7, y7, 0.15),
       {"options": options_from_jax(O7.replace(compact=False))})],
     lambda m: [jpar.lasso_sharded(X7, y7, 0.15, m, options=O7),
                jpar.lasso_sharded(X7, y7, 0.15, m,
                                   options=O7.replace(compact=False))],
     ("x", "residuals"))

# tied union-round priorities: columns 3, 35 and 67 are one column, in three
# shards, so their potential steps tie exactly; the distributed top-k must
# break the tie toward the lower global index, as lax.top_k does
X8, y8 = _gen(60, 96, 4, seed=33)
X8[:, 35] = X8[:, 3]
X8[:, 67] = X8[:, 3]
O8 = cd.CDOptions(block_size=8, compact=True, compact_size=16, opt_tol=1e-10,
                  randomize=False)
case("union_ties", 3, FEAT[3],
     [("parallel.lasso_sharded", (X8, y8, 0.05),
       {"options": options_from_jax(O8)})],
     lambda m: [jpar.lasso_sharded(X8, y8, 0.05, m, options=O8)],
     ("x", "residuals"))

X9, y9 = _gen(150, 128, 8, seed=25, sigma=0.5)
IO9 = cd.IterLassoOptions(options_cd=cd.CDOptions(
    block_size=8, compact=True, compact_size=64, extrapolate=True,
    opt_tol=1e-10, randomize=False))
case("scaled_compact_extrapolated", 2, FEAT[2],
     [("parallel.scaled_lasso_sharded",
       (X9, y9, np.sqrt(2 * np.log(128) / 150)),
       {"options": iter_options_from_jax(IO9)})],
     lambda m: [jpar.scaled_lasso_sharded(
         X9, y9, np.sqrt(2 * np.log(128) / 150), m, options=IO9)],
     check=_check_scaled)

rng10 = np.random.default_rng(67)
X10 = rng10.standard_normal((150, 96))
b10 = np.zeros(96)
b10[:6] = rng10.standard_normal(6)
y10 = X10 @ b10 + (0.2 + np.abs(X10[:, 0])) * rng10.standard_normal(150)
IO10 = {proc: cd.IterLassoOptions(options_cd=OPTS, init_procedure=proc)
        for proc in ("screening", "init_std", "warm_start")}


def _check_feasible(port, ref):
    for pt, jx in zip(port, ref):
        np.testing.assert_allclose(pt["x"], jx["x"], rtol=0, atol=ATOL)
        np.testing.assert_allclose(pt["residuals"], jx["residuals"],
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(pt["penalty"]["weights"],
                                   jx["penalty"]["weights"], rtol=0, atol=ATOL)


case("feasible", 2, FEAT[2],
     [("parallel.feasible_lasso_sharded", (X10, y10, 0.1),
       {"options": iter_options_from_jax(o)}) for o in IO10.values()],
     lambda m: [jpar.feasible_lasso_sharded(X10, y10, 0.1, m, options=o)
                for o in IO10.values()],
     check=_check_feasible)

rng11 = np.random.default_rng(73)
X11 = rng11.standard_normal((150, 96))
b11 = np.zeros(96)
b11[:6] = rng11.standard_normal(6)
y11 = X11 @ b11 + (0.02 + 0.1 * np.abs(X11[:, 0])) * rng11.standard_normal(150)
IO11 = cd.IterLassoOptions(options_cd=OPTS)
# p = 96 pads to 128 at B = 16 over 4 shards: the padded loadings must stay
# out of the stop rule's denominator
case("feasible_small_loadings_padding", 4, FEAT[4],
     [("parallel.feasible_lasso_sharded", (X11, y11, 0.05),
       {"options": iter_options_from_jax(IO11)})],
     lambda m: [jpar.feasible_lasso_sharded(X11, y11, 0.05, m,
                                            options=IO11)],
     check=_check_feasible)

# ---- the symmetric iterate -------------------------------------------------

rng12 = np.random.default_rng(59)
Q12 = cd.sym_num_coordinates(12)          # 78: uneven over 3 shards
X12 = rng12.standard_normal((90, Q12))
v12 = np.zeros(Q12)
v12[rng12.choice(Q12, 7, replace=False)] = rng12.standard_normal(7)
y12 = X12 @ v12 + 0.2 * rng12.standard_normal(90)


def _check_sym(port, ref):
    (M, r), (Mj, rj) = port[0], ref[0]
    np.testing.assert_allclose(M, Mj, rtol=0, atol=ATOL)
    np.testing.assert_allclose(r, rj, rtol=0, atol=ATOL)
    assert np.array_equal(M, M.T)


case("symmetric", 3, FEAT[3],
     [("parallel.symmetric_coordinate_descent_sharded",
       (np.zeros((12, 12)), tcd.LeastSquaresLoss(y12, X12), tcd.ProxL1(0.1)),
       {"options": T_OPTS})],
     lambda m: [jpar.symmetric_coordinate_descent_sharded(
         jnp.zeros((12, 12)),
         cd.LeastSquaresLoss(jnp.asarray(y12), jnp.asarray(X12)),
         cd.ProxL1(0.1), m, OPTS)],
     check=_check_sym)

# ---- the sharded group engine -----------------------------------------------


def _check_group(port, ref, G=4):
    for pt, jx in zip(port, ref):
        x, xj = ((pt["x"], jx["x"]) if isinstance(pt, dict)
                 else (pt[0], jx[0]))
        np.testing.assert_allclose(x, xj, rtol=0, atol=ATOL)
        if isinstance(pt, dict):
            np.testing.assert_allclose(pt["residuals"], jx["residuals"],
                                       rtol=0, atol=ATOL)
        gn = np.sqrt((x.reshape(-1, G) ** 2).sum(1))
        gj = np.sqrt((xj.reshape(-1, G) ** 2).sum(1))
        assert np.array_equal(gn == 0, gj == 0)


Xg1, yg1 = _gen_group(150, 64, 4, 6, seed=41)
case("group_lasso", 2, FEAT[2],
     [("parallel.group_lasso_sharded", (Xg1, yg1, 0.15, 4),
       {"options": T_OPTS})],
     lambda m: [jpar.group_lasso_sharded(Xg1, yg1, 0.15, 4, m,
                                         options=OPTS)],
     check=_check_group)

Xg2, yg2 = _gen_group(100, 37, 3, 4, seed=43)
case("group_lasso_uneven_groups", 3, FEAT[3],
     [("parallel.group_lasso_sharded", (Xg2, yg2, 0.2, 3),
       {"options": T_OPTS})],
     lambda m: [jpar.group_lasso_sharded(Xg2, yg2, 0.2, 3, m,
                                         options=OPTS)],
     check=lambda p, r: _check_group(p, r, 3))

Xg3, yg3 = _gen_group(120, 32, 4, 5, seed=47)
Wg3 = 0.3 + np.random.default_rng(5).random(120)
case("group_weighted_ls", 4, FEAT[4],
     [("parallel.group_coordinate_descent_sharded",
       (np.zeros(128), tcd.WeightedLSLoss(yg3, Xg3, Wg3),
        tcd.ProxL1Group(0.1, 4, None)), {"options": T_OPTS})],
     lambda m: [jpar.group_coordinate_descent_sharded(
         jnp.zeros(128), cd.WeightedLSLoss(jnp.asarray(yg3), jnp.asarray(Xg3),
                                           jnp.asarray(Wg3)),
         cd.ProxL1Group(0.1, 4, None), m, OPTS)],
     check=_check_group)

Xg4, yg4 = _gen_group(100, 32, 4, 4, seed=53)
Og4 = OPTS.replace(warm_start=False, num_steps=15)
case("group_continuation", 2, FEAT[2],
     [("parallel.group_lasso_sharded", (Xg4, yg4, 0.1, 4),
       {"options": options_from_jax(Og4)})],
     lambda m: [jpar.group_lasso_sharded(Xg4, yg4, 0.1, 4, m, options=Og4)],
     check=_check_group)

# ---- scenario batches -------------------------------------------------------

Xb1, yb1 = _gen(90, 40, 5, seed=17)
LAMS_B1 = np.exp(np.linspace(np.log(0.4), np.log(0.08), 6))   # 6 % 4 != 0
case("lambda_batch", 4, ((4,), ("batch",)),
     [("parallel.lasso_lambda_batch", (Xb1, yb1, LAMS_B1),
       {"options": T_OPTS})],
     lambda m: [jpar.lasso_lambda_batch(Xb1, yb1, LAMS_B1, m, options=OPTS)],
     (None,))

Xb2, yb2 = _gen(100, 70, 6, seed=19)                # p = 70: uneven padding
LAMS_B2 = np.exp(np.linspace(np.log(0.5), np.log(0.07), 6))
LAMW_B2 = 0.5 + np.random.default_rng(23).random(70)
GRID = ((2, 2), ("batch", "feature"))
case("lambda_grid_2d", 4, GRID,
     [("parallel.lasso_grid_sharded", (Xb2, yb2, LAMS_B2),
       {"options": T_OPTS, "standardize_X": False}),
      ("parallel.lasso_grid_sharded", (Xb2, yb2, LAMS_B2[:2]),
       {"options": T_OPTS, "weights": LAMW_B2})],
     lambda m: [jpar.lasso_grid_sharded(Xb2, yb2, LAMS_B2, m, options=OPTS,
                                        standardize_X=False),
                jpar.lasso_grid_sharded(Xb2, yb2, LAMS_B2[:2], m,
                                        options=OPTS,
                                        weights=jnp.asarray(LAMW_B2))],
     (None,))

rng_lp = np.random.default_rng(23)
X_lp = rng_lp.standard_normal((80, 3))
z_lp = rng_lp.random(80)
y_lp = (np.sum(X_lp * np.sin(2 * z_lp)[:, None], axis=1)
        + 0.1 * rng_lp.standard_normal(80))
ZG_LP = np.linspace(0.1, 0.9, 9)
case("locpoly_batch", 4, ((4,), ("batch",)),
     [("parallel.locpoly_batch",
       (X_lp, z_lp, y_lp, ZG_LP, 1, tcd.GaussianKernel(0.2)), {})],
     lambda m: [jpar.locpoly_batch(X_lp, z_lp, y_lp, ZG_LP, 1,
                                   cd.GaussianKernel(0.2), m)],
     (None,))

rng_cv = np.random.default_rng(29)
X_cv = rng_cv.standard_normal((60, 2))
z_cv = rng_cv.random(60)
y_cv = (np.sum(X_cv * np.cos(3 * z_cv)[:, None], axis=1)
        + 0.1 * rng_cv.standard_normal(60))
case("lvocv_batch", 2, ((2,), ("batch",)),
     [("parallel.lvocv_locpoly_batch",
       (X_cv, z_cv, y_cv, 0, np.array([0.1, 0.2, 0.4]), tcd.GaussianKernel),
       {})],
     lambda m: [jpar.lvocv_locpoly_batch(X_cv, z_cv, y_cv, 0,
                                         np.array([0.1, 0.2, 0.4]),
                                         cd.GaussianKernel, m)],
     (None,))

rng_l1 = np.random.default_rng(71)
z_l1 = np.sort(rng_l1.uniform(0, 1, 60))
X_l1 = rng_l1.standard_normal((60, 4))
y_l1 = np.sin(2 * np.pi * z_l1) * X_l1[:, 0] + 0.3 * rng_l1.standard_normal(60)
HS_L1 = np.asarray([0.08, 0.12, 0.2])             # 3 % 2 != 0: padding
O_L1 = cd.CDOptions(block_size=8, opt_tol=1e-9, randomize=False)


def _check_l1(port, ref):
    (m_seq, (m_b, st_b)), (j_seq, (j_b, st_j)) = port, ref
    np.testing.assert_allclose(m_seq, j_seq, rtol=1e-9, atol=ATOL)
    np.testing.assert_allclose(m_b, j_b, rtol=1e-9, atol=ATOL)
    assert st_b == st_j == {"batched_certified": True,
                            "stall_escaped_lanes": 0,
                            "lanes_resolved_sequentially": 0}


def _jax_l1(m):
    st = {}
    m_b = jpar.lvocv_locpolyl1_batch(X_l1, z_l1, y_l1, 1, HS_L1,
                                     cd.GaussianKernel, 0.05, m,
                                     options=O_L1, cv_batch=16, stats=st)
    return [jpar.lvocv_locpolyl1_batch(X_l1, z_l1, y_l1, 1, HS_L1,
                                       cd.GaussianKernel, 0.05, m,
                                       options=O_L1), (m_b, st)]


def _check_l1_fallback(port, ref):
    (m, st), jm = port[0], ref[0]
    # compact_rounds=0: no refine round, no bandwidth certifies, every one is
    # recomputed sequentially
    assert st["batched_certified"] is False
    np.testing.assert_allclose(m, jm, rtol=1e-9, atol=ATOL)


O_L1f = O_L1.replace(compact_rounds=0)
case("lvocv_locpolyl1_batch_fallback", 2, ((2,), ("batch",)),
     [("parallel.lvocv_locpolyl1_batch",
       (X_l1, z_l1, y_l1, 1, HS_L1[:2], tcd.GaussianKernel, 0.05),
       {"options": options_from_jax(O_L1f), "cv_batch": 16, "stats": {}})],
     lambda m: [jpar.lvocv_locpolyl1_batch(X_l1, z_l1, y_l1, 1, HS_L1[:2],
                                           cd.GaussianKernel, 0.05, m,
                                           options=O_L1f, cv_batch=16)],
     check=_check_l1_fallback)

case("lvocv_locpolyl1_batch", 2, ((2,), ("batch",)),
     [("parallel.lvocv_locpolyl1_batch",
       (X_l1, z_l1, y_l1, 1, HS_L1, tcd.GaussianKernel, 0.05),
       {"options": options_from_jax(O_L1), "cv_batch": 0}),
      ("parallel.lvocv_locpolyl1_batch",
       (X_l1, z_l1, y_l1, 1, HS_L1, tcd.GaussianKernel, 0.05),
       {"options": options_from_jax(O_L1), "cv_batch": 16, "stats": {}})],
     _jax_l1, check=_check_l1)


# ---------------------------------------------------------------------------


world = C.fixture()


@pytest.mark.parametrize("name", C.names([2, 3, 4]))
def test_matches_jax_sharded(world, name):
    C.run(world, name)


def test_all_names_match_jax():
    import coordinatedescent_jl_tpu_torch.parallel as tpar

    assert set(tpar.__all__) == set(jpar.__all__)
    assert len(tpar.__all__) == 27
    for name in tpar.__all__:
        assert callable(getattr(tpar, name)), name
    for name in ("lasso_sharded_with_trace", "ShardedPathCheckpoint",
                 "save_sharded_checkpoint", "load_sharded_checkpoint",
                 "lasso_path_resumable_sharded"):
        assert name in tcd.__all__ and hasattr(tcd, name), name


@pytest.mark.parametrize("entry", [
    lambda: tcd.parallel.lasso_sharded(X1, y1, 0.1, None),
    lambda: tcd.parallel.coordinate_descent_sharded(
        np.zeros(100), tcd.LeastSquaresLoss(y1, X1), tcd.ProxL1(0.1), None),
    lambda: tcd.parallel.scaled_lasso_sharded(X1, y1, 0.1, None),
    lambda: tcd.parallel.feasible_lasso_sharded(X1, y1, 0.1, None),
    lambda: tcd.parallel.lasso_path_sharded(X1, y1, [0.2, 0.1], None),
    lambda: tcd.parallel.group_lasso_sharded(X1, y1, 0.1, 4, None),
    lambda: tcd.parallel.lasso_row_sharded(X1, y1, 0.1, None),
    lambda: tcd.parallel.lasso_lambda_batch(X1, y1, [0.1], None),
    lambda: tcd.parallel.lasso_grid_sharded(X1, y1, [0.1], None),
])
def test_device_none_raises_without_gpu(entry):
    """``device=None`` means the rank's GPU: with none it raises before any
    collective."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
