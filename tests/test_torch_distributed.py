"""PyTorch port: meshes, the column plans and sharded ingestion
(``parallel/distributed.py``), the sharded checkpoint
(``utils/checkpoint.py``: ``lasso_path_resumable_sharded`` and its file) and
the multi-rank dry run (``parallel/dryrun.py``), against the JAX package on
the cases of tests/test_distributed.py and tests/test_parallel.py (the
harness is tests/torch_parity.py; Gloo worlds of spawned ranks on the CPU).

The plans are pure arithmetic and are compared with the JAX functions'
outputs.  The checkpoint: the port's resume on the same mesh shape is bit
for bit the uninterrupted run (randomized, compaction forced), which is
bit for bit the sharded scan; with ``randomize=False`` the path is within
1e-9 of the JAX one, also when it resumes a checkpoint the JAX package
wrote; another mesh shape restarts.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import coordinatedescent_jl_tpu as cd  # noqa: E402
import coordinatedescent_jl_tpu.parallel as jpar  # noqa: E402
import coordinatedescent_jl_tpu_torch as tcd  # noqa: E402
from coordinatedescent_jl_tpu_torch.parallel import (  # noqa: E402
    distributed as tdist)
from coordinatedescent_jl_tpu_torch.parallel.distributed import (  # noqa: E402
    World)
from coordinatedescent_jl_tpu_torch.parallel.dryrun import (  # noqa: E402
    dryrun_multichip)
from coordinatedescent_jl_tpu_torch.utils.convert import (  # noqa: E402
    options_from_jax, sharded_checkpoint_from_jax)
from torch_parity import ATOL, Cases, gen, jmesh, same  # noqa: E402
from torch_rank_calls import Call, run_calls  # noqa: E402

C = Cases()
FEAT = {D: ((D,), ("feature",)) for D in (2, 3, 4)}
TMP = tempfile.mkdtemp(prefix="torch_distributed_")

# ---- meshes -----------------------------------------------------------------


def _check_meshes(port, ref):
    feat, grid, bad = port
    assert feat["names"] == ("feature",) and feat["shape"] == (4,)
    assert grid["names"] == ("batch", "feature")
    assert grid["shape"] == (2, 2)
    assert "ValueError" in bad["_error"] and "divisible" in bad["_error"]
    assert ref == [("feature",), ("batch", "feature")]


C.add("mesh_constructors", 4, None,
      [("parallel.distributed.feature_mesh", (), {}),
       ("parallel.distributed.grid_mesh", (2,), {}),
       ("parallel.distributed.grid_mesh", (3,), {})],
      lambda m: [jpar.feature_mesh().axis_names,
                 jpar.grid_mesh(2).axis_names],
      check=_check_meshes)

# ---- sharded ingestion ------------------------------------------------------

rng = np.random.default_rng(1)
N1, P1 = 96, 64
X1 = rng.standard_normal((N1, P1))
b1 = np.zeros(P1)
b1[rng.choice(P1, 6, replace=False)] = rng.standard_normal(6)
y1 = X1 @ b1 + 0.2 * rng.standard_normal(N1)
F1 = os.path.join(TMP, "X.bin")
X1.tofile(F1)
O1 = cd.CDOptions(block_size=8, randomize=False, opt_tol=1e-10)


def _check_ingested(port, ref):
    """The JAX global array keeps the plan's tail padding (66 columns at 3
    ranks), so its solution has zeros past p; the port's has p entries."""
    x, xj = port[0]["x"], ref[0]["x"]
    np.testing.assert_allclose(x, xj[:P1], rtol=0, atol=ATOL)
    assert not np.any(xj[P1:])
    np.testing.assert_allclose(port[0]["residuals"], ref[0]["residuals"],
                               rtol=0, atol=ATOL)


for D in (2, 3):
    # D = 3: the plan's blocks (22 columns) are not the solver's (24): the
    # rank's columns are reassembled from the others' blocks
    C.add(f"shard_design_matrix_and_solve_{D}", D, FEAT[D],
          [("parallel.lasso_sharded",
            (Call("parallel.distributed.load_sharded_design", (F1, N1, P1),
                  {"dtype": np.float64}), y1, 0.1),
            {"options": options_from_jax(O1)})],
          lambda m: [jpar.lasso_sharded(jpar.shard_design_matrix(
              m, X1, N1, P1), y1, 0.1, m, options=O1)],
          check=_check_ingested)


def _check_interior(port, ref):
    assert "interior zero columns" in port[0]["_error"]


# p = 5 over 4 ranks: widths 2, 2, 1, 0 would need an interior gap
C.add("shard_design_matrix_rejects_interior_padding", 4, FEAT[4],
      [("parallel.distributed.shard_design_matrix", (),
        {"x_local": np.zeros((4, 2)), "n": 4, "p": 5})],
      lambda m: [], check=_check_interior)

# ---- the sharded checkpoint, first half: the uninterrupted runs ----------

XC, yC = gen(120, 256, 8, seed=31)
LAMS_C = (float(np.abs(XC.T @ yC / 120).max())
          * np.logspace(-0.3, -1.7, 8))
O_R = cd.CDOptions(block_size=8, compact=True, compact_size=32,
                   randomize=True)
O_D = O_R.replace(randomize=False, opt_tol=1e-10)
FILES = {k: os.path.join(TMP, f"{k}.npz")
         for k in ("full", "interrupted", "det", "jax", "other_mesh")}


def _resumable(lams, f, opts):
    return ("utils.checkpoint.lasso_path_resumable_sharded",
            (XC, yC, lams, f),
            {"options": options_from_jax(opts), "standardize_X": False,
             "seed": 3})


C.add("checkpoint_runs", 2, FEAT[2],
      [_resumable(LAMS_C, FILES["full"], O_R),
       _resumable(LAMS_C[:4], FILES["interrupted"], O_R),
       ("parallel.lasso_path_sharded", (XC, yC, LAMS_C),
        {"options": options_from_jax(O_R), "standardize_X": False,
         "seed": 3, "path_batch": 0}),
       _resumable(LAMS_C, FILES["det"], O_D)],
      lambda m: [], check=lambda port, ref: None)

world = C.fixture()


@pytest.fixture(scope="module", autouse=True)
def _tmpdir():
    yield
    shutil.rmtree(TMP, ignore_errors=True)


@pytest.mark.parametrize("name", [n for n in C.names([3, 4, 2])
                                  if n != "checkpoint_runs"])
def test_matches_jax(world, name):
    C.run(world, name)


# ---- the sharded checkpoint, second half: the resumes ---------------------


@pytest.fixture(scope="module")
def resumed(world):
    """The first half's results, then two worlds: the resumes on the same
    mesh shape (2 ranks) and on another (3 ranks)."""
    first = world("checkpoint_runs")
    assert same(first[1], first[0])
    runs = first[0]
    for r in runs:
        assert not (isinstance(r, dict) and "_error" in r), r
    # an interrupted run's file: the first 4 points under the whole grid
    ck = tcd.load_sharded_checkpoint(FILES["interrupted"])
    assert ck.n_shards == 2 and ck.next_index == 4 and ck.key.shape[0] == 3
    tcd.save_sharded_checkpoint(FILES["interrupted"], ck._replace(
        lam_path=np.asarray(LAMS_C)))
    # a file the JAX package wrote, interrupted the same way, converted
    m = jmesh(*FEAT[2])
    jf = os.path.join(TMP, "jax_written.npz")
    cd.lasso_path_resumable_sharded(XC, yC, LAMS_C[:4], jf, m, options=O_D,
                                    standardize_X=False, seed=3)
    jck = cd.load_sharded_checkpoint(jf)
    cd.save_sharded_checkpoint(jf, jck._replace(lam_path=np.asarray(LAMS_C)))
    tcd.save_sharded_checkpoint(FILES["jax"], sharded_checkpoint_from_jax(jf))
    shutil.copy(FILES["full"], FILES["other_mesh"])
    worlds = [World(run_calls, 2, ([
        (c[0], FEAT[2], c[1], c[2]) for c in (
            _resumable(LAMS_C, FILES["interrupted"], O_R),
            _resumable(LAMS_C, FILES["jax"], O_D))], "cpu"), timeout=120),
        World(run_calls, 3, ([
            (c[0], FEAT[3], c[1], c[2]) for c in (
                _resumable(LAMS_C, FILES["other_mesh"], O_R),)], "cpu"),
            timeout=120)]
    try:
        two, three = (w.wait() for w in worlds)
    except OSError as e:
        pytest.skip(f"cannot spawn a world of ranks here: {e}")
    assert same(two[1], two[0]) and same(three[2], three[0])
    return dict(full=runs[0], scan=runs[2], det=runs[3],
                resumed=two[0][0], resumed_jax=two[0][1],
                other_mesh=three[0][0])


def test_sharded_resume_is_bitwise(resumed):
    assert np.array_equal(resumed["resumed"]["beta_path"],
                          resumed["full"]["beta_path"])
    c1 = tcd.load_sharded_checkpoint(FILES["full"])
    c2 = tcd.load_sharded_checkpoint(FILES["interrupted"])
    for fld in ("beta_warm", "residuals", "key", "c", "drift", "active",
                "ws_idx", "ws_ok", "beta_prev", "lam_k", "lam_km1",
                "beta_path", "next_index", "n_shards"):
        assert np.array_equal(getattr(c1, fld), getattr(c2, fld)), fld


def test_sharded_resumable_is_the_scan(resumed):
    assert np.array_equal(resumed["scan"]["beta_path"],
                          resumed["full"]["beta_path"])


def test_sharded_resumable_matches_jax_path(resumed):
    jp = cd.lasso_path_resumable_sharded(
        XC, yC, LAMS_C, os.path.join(TMP, "jax_det_full.npz"),
        jmesh(*FEAT[2]), options=O_D, standardize_X=False, seed=3)
    np.testing.assert_allclose(resumed["det"]["beta_path"],
                               np.asarray(jp.beta_path), rtol=0, atol=ATOL)
    # resuming the file the JAX package wrote follows the JAX path
    np.testing.assert_allclose(resumed["resumed_jax"]["beta_path"],
                               np.asarray(jp.beta_path), rtol=0, atol=ATOL)


def test_other_mesh_shape_restarts(resumed):
    np.testing.assert_allclose(resumed["other_mesh"]["beta_path"],
                               resumed["full"]["beta_path"], rtol=0, atol=1e-5)
    assert tcd.load_sharded_checkpoint(FILES["other_mesh"]).n_shards == 3


def test_jax_key_is_not_a_port_checkpoint():
    """A file the JAX package wrote (its (2,) uint32 key) loads as ``None``
    until converted."""
    jf = os.path.join(TMP, "jax_written.npz")
    if not os.path.exists(jf):
        pytest.skip("needs the resume fixture's file")
    assert tcd.load_sharded_checkpoint(jf) is None


# ---- plans (pure arithmetic) ----------------------------------------------


@pytest.mark.parametrize("p,num", [(24, 3), (25, 3), (1, 4), (7, 8),
                                   (1000, 7), (64, 1)])
def test_plan_column_shards(p, num):
    plan = tdist.plan_column_shards(p, num)
    assert plan == [tuple(t) for t in jpar.plan_column_shards(p, num)]
    cover, prev = [], 0
    for lo, hi in plan:
        assert lo == prev and hi >= lo
        cover.extend(range(lo, hi))
        prev = hi
    assert cover == list(range(p))


@pytest.mark.parametrize("p_local,nd", [(16, 4), (17, 4), (3, 8), (8, 1),
                                        (0, 2)])
def test_plan_device_columns(p_local, nd):
    plan = tdist.plan_device_columns(p_local, nd)
    assert plan == [tuple(t) for t in jpar.plan_device_columns(p_local, nd)]
    assert len({hi - lo + pad for lo, hi, pad in plan}) == 1


def test_shard_plans_compose_to_global_matrix():
    """A fake 4-rank layout with only the last rank ragged (the contract
    ``shard_design_matrix`` enforces): the plan's blocks, padded at the
    global tail, reassemble the design; the solver's own columns
    (``_shard_chunk``) are the same columns, padded at the tail only."""
    from coordinatedescent_jl_tpu_torch.parallel.sharded_cd import (
        _shard_chunk)

    X = np.random.default_rng(2).standard_normal((8, 29))
    shards = tdist.plan_column_shards(29, 4)
    widths = [hi - lo for lo, hi in shards]
    assert all(w == widths[0] for w in widths[:-1])
    glob = np.concatenate([X[:, lo:hi] for lo, hi in shards], axis=1)
    np.testing.assert_array_equal(glob, X)
    chunk, P_tot = _shard_chunk(29, 4, 4)
    assert (chunk, P_tot) == (8, 32)
    padded = np.pad(X, ((0, 0), (0, P_tot - 29)))
    own = [padded[:, s * chunk:(s + 1) * chunk] for s in range(4)]
    np.testing.assert_array_equal(np.concatenate(own, axis=1)[:, :29], X)
    assert not np.any(np.concatenate(own, axis=1)[:, 29:])


@pytest.mark.parametrize("n,p,D,B,nbytes", [
    (96, 64, 3, 8, 2304),         # the ingestion case above: 22 vs 24 wide
    (96, 64, 2, 8, 0),            # the plan is already the solver's layout
    (10_000, 100_000, 4, 128, 21_120_000)])   # the bench shape
def test_column_exchange_moves_only_the_offsets(n, p, D, B, nbytes):
    """From the plan's blocks to the solver's ranges a rank receives only
    the columns by which the two layouts are offset, fewer than ``B·D``,
    from its right neighbour, and has every column of its range after it
    (``nbytes``: all ranks' receives, at f32)."""
    from coordinatedescent_jl_tpu_torch.parallel.sharded_cd import (
        _shard_chunk)

    plan = tdist.plan_column_shards(p, D)
    chunk, _ = _shard_chunk(p, D, B)
    ranges = [(min(s * chunk, p), min((s + 1) * chunk, p)) for s in range(D)]
    pieces = tdist.column_exchange([(lo, hi - lo) for lo, hi in plan],
                                   ranges)
    cols = sum(b - a for _, _, a, b in pieces)
    assert cols * n * 4 == nbytes
    assert all(sum(b - a for _, d, a, b in pieces if d == r) < B * D
               for r in range(D))
    assert all(src == dst + 1 for src, dst, _, _ in pieces)
    for d, (lo, hi) in enumerate(ranges):
        own_lo, own_hi = plan[d]
        have = set(range(max(lo, own_lo), min(hi, own_hi)))
        for _, dst, a, b in pieces:
            if dst == d:
                have |= set(range(a, b))
        assert have == set(range(lo, hi))


def test_load_design_shard_matches_jax():
    n, p = 40, 24
    X = np.random.default_rng(0).standard_normal((n, p)).astype(np.float32)
    f = os.path.join(TMP, "X32.bin")
    X.tofile(f)
    parts = [tdist.load_design_shard(f, n, p, i, 3) for i in range(3)]
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), X)
    for i in range(3):
        np.testing.assert_array_equal(parts[i],
                                      jpar.load_design_shard(f, n, p, i, 3))


def test_layout_check_offsets():
    """The plan check of ``shard_design_matrix``: the offsets of a legal
    layout (only the last rank ragged), the errors of an illegal one."""
    assert [tdist._check_layout(29, 4, s, w)
            for s, w in enumerate((8, 8, 8, 5))] == [0, 8, 16, 24]
    with pytest.raises(ValueError, match="interior zero columns"):
        tdist._check_layout(5, 4, 0, 2)
    with pytest.raises(ValueError, match="owns"):
        tdist._check_layout(29, 4, 1, 7)


def test_dryrun_multichip_completes_on_gloo():
    try:
        line = dryrun_multichip(4, device="cpu")
    except OSError as e:
        pytest.skip(f"cannot spawn a world of ranks here: {e}")
    assert line.startswith("dryrun_multichip(4): ok (mesh 2x2")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a GPU")
def test_dryrun_multichip_defaults_to_the_card():
    """Without ``device="cpu"`` the dry run runs on the card: here, with
    no GPU, it raises before it starts a rank."""
    with pytest.raises(RuntimeError, match="no usable CUDA device"):
        dryrun_multichip(2)
