"""PyTorch port: the observation-sharded and tile-sharded tiers
(``coordinatedescent_jl_tpu_torch/parallel/row_sharded.py``) against the
JAX package's on the same mesh shape, on the cases of tests/test_parallel.py
(the JAX tests' 8-device meshes cut to 2-4 ranks; the harness is
tests/torch_parity.py).  Float64, ``randomize=False``: within 1e-9
absolute of the JAX sharded result; a randomized run (its orders are the
port's own) within 1e-9 of the JAX run at ``opt_tol = 1e-10``.
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
    options_from_jax)
from torch_parity import ATOL, Cases, gen, jax_error, same  # noqa: E402

OPTS = cd.CDOptions(block_size=16, randomize=False, opt_tol=1e-10)
T_OPTS = options_from_jax(OPTS)
OBS = {D: ((D,), ("obs",)) for D in (2, 3, 4)}
TILE = ((2, 2), ("obs", "feature"))
C = Cases()
SOL = ("x", "residuals", "sigma")


def _sol(name, D, mesh, fn, X, y, lam, opts=OPTS, **kw):
    """A case of a ``LassoSolution`` entry point (``fn`` its name)."""
    C.add(name, D, mesh,
          [(f"parallel.{fn}", (X, y, lam),
            {"options": options_from_jax(opts), **kw})],
          lambda m: [getattr(jpar, fn)(X, y, lam, m, options=opts, **kw)],
          SOL)


X1, y1 = gen(160, 64, 8)
_sol("row_lasso", 4, OBS[4], "lasso_row_sharded", X1, y1, 0.1)
X2, y2 = gen(101, 40, 5, seed=3)                  # 101 rows over 3 ranks
_sol("row_uneven_n", 3, OBS[3], "lasso_row_sharded", X2, y2, 0.12)
X3, y3 = gen(152, 48, 6, seed=7)
_sol("row_sqrt_lasso", 4, OBS[4], "sqrt_lasso_row_sharded", X3, y3,
     0.3 / np.sqrt(152))
X4, y4 = gen(128, 40, 5, seed=5)
_sol("row_cold_continuation", 2, OBS[2], "lasso_row_sharded", X4, y4, 0.05,
     OPTS.replace(warm_start=False, num_steps=20))
X5, y5 = gen(160, 96, 8)
_sol("tile_lasso", 4, TILE, "lasso_tile_sharded", X5, y5, 0.1)
X6, y6 = gen(101, 37, 5, seed=3)                  # both dimensions pad
_sol("tile_uneven_both_dims", 4, TILE, "lasso_tile_sharded", X6, y6, 0.12)
X7, y7 = gen(120, 48, 6, seed=5)
_sol("tile_cold_continuation", 4, TILE, "lasso_tile_sharded", X7, y7, 0.05,
     OPTS.replace(warm_start=False, num_steps=20))
# randomized orders (the port's own) reach the JAX fixed point
C.add("tile_randomize", 4, TILE,
      [("parallel.lasso_tile_sharded", (X7, y7, 0.1),
        {"options": options_from_jax(OPTS.replace(randomize=True))})],
      lambda m: [jpar.lasso_tile_sharded(X7, y7, 0.1, m, options=OPTS)],
      ("x", "residuals"))

X8, y8 = gen(120, 48, 6, seed=1)
W8 = 0.5 + np.random.default_rng(11).random(120)
C.add("row_weighted_ls", 2, OBS[2],
      [("parallel.coordinate_descent_row_sharded",
        (np.zeros(48), tcd.WeightedLSLoss(y8, X8, W8), tcd.ProxL1(0.08)),
        {"options": T_OPTS})],
      lambda m: [jpar.coordinate_descent_row_sharded(
          jnp.zeros(48), cd.WeightedLSLoss(jnp.asarray(y8), jnp.asarray(X8),
                                           jnp.asarray(W8)),
          cd.ProxL1(0.08), m, OPTS)],
      (0, 1))

X9, y9 = gen(120, 48, 6, seed=7)
LAM9 = 0.3 / np.sqrt(120)
C.add("tile_sqrt_and_wls", 4, TILE,
      [("parallel.coordinate_descent_row_sharded",
        (np.zeros(48), tcd.SqrtLassoLoss(y9, X9), tcd.ProxL1(LAM9)),
        {"options": T_OPTS, "feat_axis": "feature"}),
       ("parallel.coordinate_descent_row_sharded",
        (np.zeros(48), tcd.WeightedLSLoss(y9, X9, W8), tcd.ProxL1(0.08)),
        {"options": T_OPTS, "feat_axis": "feature"})],
      lambda m: [jpar.coordinate_descent_row_sharded(
          jnp.zeros(48), cd.SqrtLassoLoss(jnp.asarray(y9), jnp.asarray(X9)),
          cd.ProxL1(LAM9), m, OPTS, feat_axis="feature"),
          jpar.coordinate_descent_row_sharded(
          jnp.zeros(48), cd.WeightedLSLoss(jnp.asarray(y9), jnp.asarray(X9),
                                           jnp.asarray(W8)),
          cd.ProxL1(0.08), m, OPTS, feat_axis="feature")],
      (0, 1))

X10, y10 = gen(120, 48, 6, seed=19)
LAMW10 = 0.5 + np.random.default_rng(21).random(48)
C.add("row_penalty_weights_and_proxzero", 2, OBS[2],
      [("parallel.lasso_row_sharded", (X10, y10, 0.08),
        {"options": T_OPTS, "weights": LAMW10}),
       ("parallel.coordinate_descent_row_sharded",
        (np.zeros(48), tcd.LeastSquaresLoss(y10, X10), tcd.ProxZero()),
        {"options": T_OPTS})],
      lambda m: [jpar.lasso_row_sharded(X10, y10, 0.08, m, options=OPTS,
                                        weights=jnp.asarray(LAMW10)),
                 jpar.coordinate_descent_row_sharded(
                     jnp.zeros(48), cd.LeastSquaresLoss(jnp.asarray(y10),
                                                        jnp.asarray(X10)),
                     cd.ProxZero(), m, OPTS)],
      check=lambda p, r: (
          np.testing.assert_allclose(p[0]["x"], r[0]["x"], rtol=0, atol=ATOL),
          np.testing.assert_allclose(p[1][0], r[1][0], rtol=0, atol=ATOL),
          np.testing.assert_allclose(p[1][1], r[1][1], rtol=0, atol=ATOL)))


def _check_errors(*wants):
    def check(port, ref):
        for pt, jx, want in zip(port, ref, wants):
            assert "_error" in pt and want in pt["_error"], pt
            assert jx["_error"].split(":")[0] == pt["_error"].split(":")[0]
    return check


X11, y11 = gen(60, 32, 4)
LS11 = (tcd.LeastSquaresLoss(y11, X11),
        cd.LeastSquaresLoss(jnp.asarray(y11), jnp.asarray(X11)))
C.add("tile_axis_validation", 2, OBS[2],
      [("parallel.coordinate_descent_row_sharded",
        (np.zeros(32), LS11[0], tcd.ProxL1(0.1)),
        {"options": T_OPTS, "feat_axis": fa}) for fa in ("obs", "nope")],
      lambda m: [jax_error(lambda: jpar.coordinate_descent_row_sharded(
          jnp.zeros(32), LS11[1], cd.ProxL1(0.1), m, OPTS, feat_axis=fa))
          for fa in ("obs", "nope")],
      check=_check_errors("must differ", "not in mesh"))

C.add("row_length_mismatch_raises", 2, OBS[2],
      [("parallel.coordinate_descent_row_sharded",
        (np.zeros(32), tcd.WeightedLSLoss(y11, X11, np.ones(59)),
         tcd.ProxL1(0.1)), {"options": T_OPTS}),
       ("parallel.coordinate_descent_row_sharded",
        (np.zeros(31), LS11[0], tcd.ProxL1(0.1)), {"options": T_OPTS})],
      lambda m: [jax_error(lambda: jpar.coordinate_descent_row_sharded(
          jnp.zeros(32), cd.WeightedLSLoss(jnp.asarray(y11),
                                           jnp.asarray(X11), jnp.ones(59)),
          cd.ProxL1(0.1), m, OPTS)),
          jax_error(lambda: jpar.coordinate_descent_row_sharded(
              jnp.zeros(31), LS11[1], cd.ProxL1(0.1), m, OPTS))],
      check=_check_errors("weights have", "beta0 has"))

# ---- paths ----------------------------------------------------------------

X12, y12 = gen(120, 48, 6, seed=13)
L12 = np.exp(np.linspace(np.log(0.5), np.log(0.05), 8))
L12s = np.exp(np.linspace(np.log(0.5), np.log(0.01), 10))


def _path(X, y, lams, **kw):
    return ("parallel.lasso_path_row_sharded", (X, y, lams),
            {"options": T_OPTS, "standardize_X": False, **kw})


def _jpath(m, X, y, lams, **kw):
    return jpar.lasso_path_row_sharded(X, y, lams, m, options=OPTS,
                                       standardize_X=False, **kw)


def _check_paths(port, ref):
    for pt, jx in zip(port, ref):
        assert pt["beta_path"].shape == jx["beta_path"].shape
        np.testing.assert_allclose(pt["beta_path"], jx["beta_path"],
                                   rtol=0, atol=ATOL)


C.add("row_path", 4, OBS[4],
      [_path(X12, y12, L12), _path(X12, y12, L12s, max_hat_s=10),
       ("parallel.lasso_path_row_sharded", (X12, y12, L12),
        {"options": T_OPTS})],
      lambda m: [_jpath(m, X12, y12, L12),
                 _jpath(m, X12, y12, L12s, max_hat_s=10),
                 jpar.lasso_path_row_sharded(X12, y12, L12, m,
                                             options=OPTS)],
      check=_check_paths)
C.add("tile_path", 4, TILE,
      [_path(X12, y12, L12, feat_axis="feature")],
      lambda m: [_jpath(m, X12, y12, L12, feat_axis="feature")],
      check=_check_paths)

# scan_chunk is taken, checked and ignored: the chunked runs are the scan
X13, y13 = gen(96, 40, 6, seed=29)
L13 = np.exp(np.linspace(np.log(0.5), np.log(0.03), 9))


def _chunk_case(name, D, mesh, fa):
    def check(port, ref):
        assert same(port[1], port[0]) and same(port[3], port[2])
        _check_paths([port[0], port[2]], ref)

    C.add(name, D, mesh,
          [_path(X13, y13, L13, feat_axis=fa, scan_chunk=ch)
           for ch in (None, 3)]
          + [_path(X13, y13, L13, feat_axis=fa, max_hat_s=8, scan_chunk=ch)
             for ch in (None, 2)],
          lambda m: [_jpath(m, X13, y13, L13, feat_axis=fa),
                     _jpath(m, X13, y13, L13, feat_axis=fa, max_hat_s=8)],
          check=check)


_chunk_case("row_path_scan_chunk_ignored", 2, OBS[2], None)
_chunk_case("tile_path_scan_chunk_ignored", 4, TILE, "feature")

world = C.fixture()


@pytest.mark.parametrize("name", C.names([2, 3, 4]))
def test_matches_jax_sharded(world, name):
    C.run(world, name)
