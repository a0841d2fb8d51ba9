"""Shared harness of the multi-device parity tests
(tests/test_torch_parallel*.py, tests/test_torch_row_sharded.py,
tests/test_torch_distributed.py): a case is
a list of calls of the port's entry points, made in a Gloo world of D
spawned ranks on the CPU through ``torch_rank_calls.run_calls``, and a
function giving the JAX package's results on a mesh of the first D devices
of conftest's 8-device CPU mesh.  One world per D and module, all started
when the module's first case runs; the JAX references compile meanwhile,
two at a time in threads; a case reads its calls' results as soon as
every rank has made them.  Every rank's result must be the same (the
results are replicated)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from coordinatedescent_jl_tpu_torch.parallel.distributed import World
from torch_rank_calls import run_calls

ATOL = 1e-9


def gen(n, p, s, seed=0, sigma=0.3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta = np.zeros(p)
    beta[:s] = rng.standard_normal(s)
    return X, X @ beta + sigma * rng.standard_normal(n)


def host(obj):
    """A JAX result in the port's ``to_host`` layout (named tuples as
    dicts, arrays as numpy)."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {f: host(getattr(obj, f)) for f in obj._fields}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: host(v) for k, v in obj.items()}
    if obj is None or isinstance(obj, (str, bool, int, float)):
        return obj
    return np.asarray(obj)


def same(a, b):
    """Bitwise equality of two ``to_host`` results (``_type`` ignored, and
    a trace's ``seconds``, each rank's own clock)."""
    if isinstance(a, dict):
        ka = {k for k in a if k not in ("_type", "seconds")}
        kb = {k for k in b if k not in ("_type", "seconds")}
        return ka == kb and all(same(a[k], b[k]) for k in ka)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def jmesh(shape, names):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def jax_error(fn):
    """``{"_error": "<type>: <message>"}`` of a JAX call that must raise."""
    try:
        fn()
    except Exception as e:            # noqa: BLE001 (the message is compared)
        return {"_error": f"{type(e).__name__}: {e}"}
    raise AssertionError("the JAX call did not raise")


class Cases:
    """A module's parity cases: ``add(name, D, mesh, calls, ref, fields,
    check)`` registers the port's ``calls`` [(target, args, kwargs)] on a
    world of ``D`` ranks with ``mesh`` (shape, names), ``ref(jax_mesh)``
    the JAX results, one per call, compared on ``fields`` within ``ATOL``
    (``None`` for the whole result, an int for a tuple position) or by
    ``check(port, jax)``."""

    def __init__(self):
        self.cases = {}
        self.order = []          # the worlds' order of the tests (names())

    def add(self, name, D, mesh, calls, ref, fields=None, check=None):
        self.cases[name] = dict(D=D, mesh=mesh, calls=calls, ref=ref,
                                fields=fields, check=check)

    def names(self, order):
        """The case names, the worlds of ``order`` first to last."""
        self.order = list(order)
        return sorted(self.cases, key=lambda k: self.order.index(
            self.cases[k]["D"]))

    def fixture(self):
        """A module-scoped fixture: ``get(name)`` gives the ranks' results of
        a case (a list over the ranks of the list over its calls)."""
        cases = self.cases

        @pytest.fixture(scope="module")
        def world():
            by_d = {}
            for k, c in cases.items():
                by_d.setdefault(c["D"], []).append(k)
            started = {D: World(run_calls, D, (
                [(t, cases[k]["mesh"], a, kw) for k in names
                 for t, a, kw in cases[k]["calls"]], "cpu"), timeout=120)
                for D, names in by_d.items()}
            first = {}
            for D, names in by_d.items():
                i = 0
                for k in names:
                    first[k] = i
                    i += len(cases[k]["calls"])

            def get(name):
                """The ranks' results of a case, as soon as its calls are
                done in every rank."""
                c, i = cases[name], first[name]
                try:
                    parts = [started[c["D"]].part(j)
                             for j in range(i, i + len(c["calls"]))]
                except OSError as e:
                    pytest.skip(f"cannot spawn a world of ranks here: {e}")
                return [list(r) for r in zip(*parts)]

            # the JAX references of the cases, two at a time in threads (their
            # XLA compiles overlap), in the order the tests read them
            pool = ThreadPoolExecutor(max_workers=2)
            get.refs = {k: pool.submit(self._ref, k)
                        for k in self.names(self.order or sorted(by_d))}
            yield get
            pool.shutdown(cancel_futures=True)
            for w in started.values():
                w.close()

        return world

    def _ref(self, name):
        c = self.cases[name]
        return [host(v) for v in c["ref"](
            jmesh(*c["mesh"]) if c["mesh"] else None)]

    def run(self, world, name):
        """Compare a case: the JAX reference (computed while the worlds
        run), then the port's result, the same on every rank."""
        c = self.cases[name]
        ref = world.refs[name].result()
        ranks = world(name)
        port = ranks[0]
        for r in ranks[1:]:
            assert same(r, port), "the ranks' results differ"
        if c["check"] is not None:
            c["check"](port, ref)
            return
        for res in port:
            assert not (isinstance(res, dict) and "_error" in res), res
        for pt, jx in zip(port, ref):
            for f in c["fields"]:
                a, b = (pt, jx) if f is None else (pt[f], jx[f])
                np.testing.assert_allclose(a, b, rtol=0, atol=ATOL,
                                           err_msg=str(f))
