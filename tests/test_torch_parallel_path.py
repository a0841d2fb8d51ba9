"""PyTorch port: the feature-sharded λ paths (the scan, the batched
execution on the feature mesh and on a 2-D ``("batch", "feature")`` mesh,
the secant start with compaction, ``scan_chunk``), the sharded per-epoch
trace and a wide f32 problem, against the JAX package's ``parallel`` on
the same mesh shape (the cases of tests/test_parallel.py; the harness is
tests/torch_parity.py).

Float64 with ``randomize=False``: within 1e-9 absolute of the JAX sharded
result, the trace's epoch counts equal (D = 2 and 4 here; the uneven D = 3
cases are in tests/test_torch_parallel.py).  The wide case is float32 (as the
JAX test): within its 5e-4 of the JAX sharded solution.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import coordinatedescent_jl_tpu as cd  # noqa: E402
import coordinatedescent_jl_tpu.parallel as jpar  # noqa: E402
from coordinatedescent_jl_tpu_torch.utils.convert import (  # noqa: E402
    options_from_jax)
from torch_parity import ATOL, Cases, gen, jax_error, same  # noqa: E402

OPTS = cd.CDOptions(block_size=16, randomize=False, opt_tol=1e-10)
T_OPTS = options_from_jax(OPTS)
FEAT = {D: ((D,), ("feature",)) for D in (2, 4)}
C = Cases()


def _path_call(X, y, lams, opts, **kw):
    return ("parallel.lasso_path_sharded", (X, y, lams),
            {"options": options_from_jax(opts), **kw})


def _check_paths(port, ref):
    for pt, jx in zip(port, ref):
        if isinstance(pt, tuple):                  # (path, stats)
            assert pt[1] == jx[1], (pt[1], jx[1])
            pt, jx = pt[0], jx[0]
        assert pt["beta_path"].shape == jx["beta_path"].shape
        np.testing.assert_allclose(pt["lam_path"], jx["lam_path"], rtol=0)
        np.testing.assert_allclose(pt["beta_path"], jx["beta_path"],
                                   rtol=0, atol=ATOL)


def _case(name, D, mesh, X, y, lams, opts, **kw):
    """A path case: the port's ``lasso_path_sharded`` against JAX's."""
    call = _path_call(X, y, lams, opts, **kw)

    def ref(m):
        if "stats" in kw:
            st = {}
            out = jpar.lasso_path_sharded(X, y, lams, m, options=opts,
                                          **{**kw, "stats": st})
            return [(out, st)]
        return [jpar.lasso_path_sharded(X, y, lams, m, options=opts, **kw)]

    C.add(name, D, mesh, [call], ref, check=_check_paths)


X1, y1 = gen(100, 48, 6, seed=13)
L1 = np.exp(np.linspace(np.log(0.5), np.log(0.05), 8))
_case("path", 2, FEAT[2], X1, y1, L1, OPTS, standardize_X=False)
_case("path_standardized", 2, FEAT[2], X1, y1, L1, OPTS)
L2 = np.exp(np.linspace(np.log(0.5), np.log(0.01), 10))
_case("path_early_stop", 2, FEAT[2], X1, y1, L2, OPTS, max_hat_s=10,
      standardize_X=False)

X3, y3 = gen(150, 96, 8, seed=17)
L3 = float(np.abs(X3.T @ y3 / 150).max()) * np.logspace(-0.1, -2, 12)
_case("batched_matches_scan", 2, FEAT[2], X3, y3, L3, OPTS,
      standardize_X=False, path_batch=4, coarse_stride=4, stats={})
# p = 48 pads to 64 over 4 shards: most union candidates are zero columns
_case("batched_early_stop_padding", 4, FEAT[4], X1, y1, L2, OPTS,
      max_hat_s=10, standardize_X=False, path_batch=4, coarse_stride=3)
# compact_size 40 < 96: the real distributed top-k, and the pad slots of
# Cp = 48 != C
_case("batched_small_compact_size", 2, FEAT[2], X3, y3, L3,
      OPTS.replace(compact_size=40), standardize_X=False, path_batch=4,
      coarse_stride=4)
GRID = ((2, 2), ("batch", "feature"))
_case("batched_2d_mesh", 4, GRID, X3, y3, L3, OPTS, standardize_X=False,
      path_batch=2, coarse_stride=4, batch_axis="batch")
# 7 rest lanes → 4 chunks over the 2 batch rows
_case("batched_2d_mesh_uneven_chunks", 4, GRID, X3, y3, L3, OPTS,
      standardize_X=False, path_batch=2, coarse_stride=3,
      batch_axis="batch")


def _check_errors(port, ref):
    for pt, jx, want in zip(port, ref, ("must differ", "not in mesh")):
        assert "_error" in pt and want in pt["_error"], pt
        assert jx["_error"].split(":")[0] == pt["_error"].split(":")[0]


X5, y5 = gen(60, 32, 4)
L5 = np.linspace(0.5, 0.1, 6)
C.add("batch_axis_validation", 2, FEAT[2],
      [_path_call(X5, y5, L5, OPTS, path_batch=2, coarse_stride=2,
                  batch_axis=ax) for ax in ("feature", "nope")],
      lambda m: [jax_error(lambda: jpar.lasso_path_sharded(
          X5, y5, L5, m, options=OPTS, path_batch=2, coarse_stride=2,
          batch_axis=ax)) for ax in ("feature", "nope")],
      check=_check_errors)

X6, y6 = gen(150, 128, 8, seed=21)
L6 = float(np.abs(X6.T @ y6 / 150).max()) * np.logspace(-0.2, -1.8, 10)
O6 = cd.CDOptions(block_size=8, compact=True, compact_size=64,
                  extrapolate=True, opt_tol=1e-10, randomize=False)
_case("path_extrapolated_compact", 2, FEAT[2], X6, y6, L6, O6,
      standardize_X=False)

# scan_chunk is taken, checked and ignored: chunked runs are the plain scan
# bit for bit, also randomized and with compaction
L7 = L1           # the `path` case's grid: its JAX program serves here too
O7R = OPTS.replace(compact=True, compact_size=16, randomize=True)


def _check_chunks(port, ref):
    mono, mono_r, stop = port[0], port[2], port[4]
    assert same(port[1], mono) and same(port[3], mono_r)
    assert same(port[5], stop)
    _check_paths([mono, stop], ref)


C.add("scan_chunk_ignored", 2, FEAT[2],
      [_path_call(X1, y1, L7, o, standardize_X=False, path_batch=0,
                  scan_chunk=ch)
       for o in (OPTS, O7R) for ch in (None, 3)]
      + [_path_call(X1, y1, L2, OPTS, max_hat_s=10, standardize_X=False,
                    path_batch=0, scan_chunk=ch) for ch in (None, 3)],
      lambda m: [jpar.lasso_path_sharded(X1, y1, L7, m, options=OPTS,
                                         standardize_X=False, path_batch=0),
                 jpar.lasso_path_sharded(X1, y1, L2, m, options=OPTS,
                                         max_hat_s=10, standardize_X=False,
                                         path_batch=0)],
      check=_check_chunks)

# ---- the sharded per-epoch trace ---------------------------------------


def _check_trace(port, ref):
    for (beta, tr), (bj, tj) in zip(port, ref):
        np.testing.assert_allclose(beta, bj, rtol=0, atol=ATOL)
        assert len(tr["max_h"]) == len(tj["max_h"]), (
            len(tr["max_h"]), len(tj["max_h"]))
        np.testing.assert_array_equal(tr["nnz"], tj["nnz"])
        np.testing.assert_allclose(tr["max_h"], tj["max_h"], rtol=1e-6,
                                   atol=1e-14)
        np.testing.assert_allclose(tr["certificate"], tj["certificate"],
                                   rtol=0, atol=ATOL)
        assert np.all(np.diff(tr["seconds"]) >= 0)


X8, y8 = gen(110, 96, 8, seed=61)
O8 = cd.CDOptions(block_size=16, randomize=False)
O8c = O8.replace(compact=True, compact_size=32)
C.add("trace", 2, FEAT[2],
      [("utils.profiling.lasso_sharded_with_trace", (X8, y8, 0.12),
        {"options": options_from_jax(o)}) for o in (O8, O8c)],
      lambda m: [cd.lasso_sharded_with_trace(X8, y8, 0.12, m, options=o)
                 for o in (O8, O8c)],
      check=_check_trace)

# the union round keeps the sharded epoch count at the engine's (JAX:
# f32 at n = 2000, p = 4096 on 8 devices; here the f64 counterpart on 4)
rng9 = np.random.default_rng(17)
X9 = rng9.standard_normal((400, 1024))
b9 = np.zeros(1024)
b9[rng9.choice(1024, 20, replace=False)] = rng9.standard_normal(20)
y9 = X9 @ b9 + 0.3 * rng9.standard_normal(400)
LAM9 = 0.1 * float(np.max(np.abs(y9 @ X9)) / 400)
O9 = cd.CDOptions(block_size=32, compact=True, compact_size=256,
                  randomize=False)
C.add("union_epoch_parity", 4, FEAT[4],
      [("utils.profiling.lasso_sharded_with_trace", (X9, y9, LAM9),
        {"options": options_from_jax(O9)})],
      lambda m: [cd.lasso_sharded_with_trace(X9, y9, LAM9, m, options=O9)],
      check=_check_trace)

# ---- a wide float32 problem (the JAX test's p = 1M, cut to p = 100K) -------

rng10 = np.random.default_rng(42)
P10 = 100_000
X10 = rng10.standard_normal((32, P10)).astype(np.float32)
b10 = np.zeros(P10, np.float32)
b10[rng10.choice(P10, 5, replace=False)] = rng10.standard_normal(5)
y10 = (X10 @ b10 + 0.1 * rng10.standard_normal(32)).astype(np.float32)
LAM10 = 0.3 * float(np.max(np.abs(y10 @ X10)) / 32)
O10 = cd.CDOptions(block_size=128)


def _check_wide(port, ref):
    x, xj = port[0]["x"], ref[0]["x"]
    np.testing.assert_allclose(x, xj, rtol=0, atol=5e-4)
    r = y10.astype(np.float64) - X10.astype(np.float64) @ x
    g = np.abs(r @ X10.astype(np.float64)) / 32
    scale = min(1.0, LAM10 / g.max())
    primal = r @ r / 64 + LAM10 * np.abs(x).sum()
    dual = (y10 @ y10 - np.sum((y10 - r * scale) ** 2)) / 64
    assert (primal - dual) / primal < 1e-3


C.add("wide_f32", 2, FEAT[2],
      [("parallel.lasso_sharded", (X10, y10, LAM10),
        {"options": options_from_jax(O10)})],
      lambda m: [jpar.lasso_sharded(X10, y10, LAM10, m, options=O10)],
      check=_check_wide)

world = C.fixture()


@pytest.mark.parametrize("name", C.names([2, 4]))
def test_matches_jax_sharded(world, name):
    C.run(world, name)
