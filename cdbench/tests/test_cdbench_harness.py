"""CPU tests of the benchmark harness (``cdbench/``): names resolve, the
roofline counts match hand counts, the plain references reach their
optimality conditions, a run loads neither JAX nor the JAX package and
fails without a card, and a run whose timed path is broken underneath
comes out not correct."""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cdbench import roofline, run
from cdbench.reference import solvers
from cdbench.reference.vc_solver import locpolyl1 as vc_reference
from cdbench.tests.tiny import tiny_run

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in SPEC["workloads"]]
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _module_exists(name: str) -> bool:
    return importlib.util.find_spec(name) is not None


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell):
    c, cfg, traffic = run.resolve(SPEC, cell, ROOT)
    assert cfg["name"] == c["config"]
    assert _module_exists(f"cdbench.tasks.{traffic['task']}")
    assert _module_exists(f"cdbench.reference.{traffic['task']}")
    for kind in ("end_to_end", "per_layer"):
        for m in run.metrics_for(SPEC, cell, kind):
            assert _module_exists(f"cdbench.metrics.{m['name']}"), m["name"]
    assert set(traffic["limits"]) and set(traffic["control"]) == set(
        traffic["limits"])


def test_benchmark_json_names_and_files():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(_NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert c["file"].startswith("cdbench/") and (ROOT / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert (ROOT / "cdbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert 1 <= len(w["why"]) <= 200 and w["chips"] == 1
        e2e = run.metrics_for(SPEC, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert run.metrics_for(SPEC, w["name"], "per_layer")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e_names = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in e2e_names for m in SPEC["per_layer"])


def test_k5_counts_match_hand_counts():
    # (782, 10,000): X 782·10,000·128 floats, r 10,000, c 782·128
    assert roofline.k5_bytes(782, 10_000) == 4 * (1_000_960_000 + 10_000
                                                  + 100_096)
    assert roofline.k5_bytes(782, 10_000) == 4_004_280_384
    assert roofline.k5_flops(782, 10_000) == 2_001_920_000
    # (1, 500): one block of 500 x 128, the varying-coefficient point
    assert roofline.k5_bytes(1, 500) == 4 * (64_000 + 500 + 128) == 258_512
    assert roofline.k5_flops(1, 500) == 128_000
    # bytes bound both: 4.0e9 B at 3.35 TB/s is 1.195 ms
    t = roofline.least_seconds(roofline.k5_bytes(782, 10_000),
                               roofline.k5_flops(782, 10_000))
    assert abs(t - 4_004_280_384 / 3.35e12) < 1e-15


def test_check_counts_match_hand_counts():
    # phase A: 7 floats a coordinate (6 in, the bound out), 5 a row
    # (drift in; need, use-bound, candidate, active out), scal and maxh
    assert roofline.check_bytes("a", 782) == 4 * (7 * 100_096 + 5 * 782 + 6)
    assert roofline.check_bytes("a", 782) == 2_818_352
    assert roofline.check_bytes("a", 8) == 4 * (7 * 1024 + 40 + 6) == 28_856
    # phase B: 7 floats a coordinate in, 3 a row (ubf, candf in; active out)
    assert roofline.check_bytes("b", 782) == 4 * (7 * 100_096 + 3 * 782 + 6)
    assert roofline.check_bytes("b", 8) == 4 * (7 * 1024 + 24 + 6) == 28_792
    assert roofline.check_flops("a", 8) == 16 * 1024
    assert roofline.check_flops("b", 782) == 8 * 100_096


def _lasso_problem(n=150, p=400, s=12, seed=3):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((n, p), generator=g)
    b = torch.zeros(p)
    b[:s] = torch.randn(s, generator=g)
    y = X @ b + torch.randn(n, generator=g)
    return X, y


@pytest.mark.parametrize("frac", [0.5, 0.1, 0.03])
def test_reference_lasso_reaches_its_optimality_conditions(frac):
    X, y = _lasso_problem()
    n = X.shape[0]
    lam = frac * float(torch.amax(torch.abs(X.T @ y))) / n
    b, ok, _ = solvers.lasso(X, y, lam)
    assert ok and b.dtype == torch.float64
    g = X.double().T @ (y.double() - X.double() @ b) / n
    sup = b != 0
    assert int(sup.sum()) > 0
    assert float(torch.amax(torch.abs(g[sup] - lam * torch.sign(b[sup])))) \
        < 1e-11 * lam
    assert float(torch.amax(torch.abs(g[~sup]))) <= lam * (1 + 1e-9)


def test_reference_group_lasso_reaches_its_optimality_conditions():
    X, _ = _lasso_problem(seed=4)
    n, p = X.shape
    G = 8
    bt = torch.zeros(p)
    bt[:24] = 1.0
    y = X @ bt + 0.3 * torch.randn(n, generator=torch.Generator()
                                   .manual_seed(5))
    lam = 0.3 * float(torch.amax(torch.linalg.vector_norm(
        (X.T @ y).reshape(-1, G), dim=1))) / n
    b, ok = solvers.group_lasso(X, y, lam, G)
    assert ok
    g = (X.double().T @ (y.double() - X.double() @ b) / n).reshape(-1, G)
    bg = b.reshape(-1, G)
    act = torch.linalg.vector_norm(bg, dim=1) > 0
    assert int(act.sum()) >= 1
    want = lam * bg[act] / torch.linalg.vector_norm(bg[act], dim=1,
                                                    keepdim=True)
    assert float(torch.amax(torch.abs(g[act] - want))) < 1e-10 * lam
    assert float(torch.amax(torch.linalg.vector_norm(g[~act], dim=1))) \
        <= lam * (1 + 1e-9)


def test_reference_vc_fit_reaches_its_optimality_conditions():
    g = torch.Generator().manual_seed(6)
    n, p, h, lam0 = 80, 5, 0.1, 0.05
    X = torch.randn((n, p), generator=g)
    z = torch.rand(n, generator=g)
    y = torch.sin(2 * torch.pi * z) * X[:, 0] + 0.3 * torch.randn(
        n, generator=g)
    grid = torch.linspace(0.05, 0.95, 7)
    out = vc_reference(X, z, y, grid, 1, h, lam0)
    assert out.shape == (2 * p, 7)
    for k, z0 in enumerate(grid.double()):
        dz = z.double() - z0
        w = torch.exp(-dz * dz / h) / h
        eX = (X.double()[:, :, None] * torch.stack([torch.ones_like(dz), dz],
                                                    1)[:, None, :]).reshape(
            n, 2 * p)
        thr = n * lam0 * torch.sqrt((w[:, None] * eX * eX).sum(0) / n)
        grad = eX.T @ (w * (y.double() - eX @ out[:, k]))
        b = out[:, k]
        sup = b != 0
        dev = torch.abs(grad[sup] - thr[sup] * torch.sign(b[sup]))
        worst = float(dev.max()) if dev.numel() else 0.0
        assert worst < 1e-9 * float(thr.max())
        assert bool(torch.all(torch.abs(grad[~sup]) <= thr[~sup] * (1 + 1e-9)))


_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
from cdbench.tests.tiny import tiny_run
rec = tiny_run({cell!r})
assert rec["correct"], rec["checks"]
import cdbench.reference, cdbench.reference.solvers, cdbench.reference.vc_solver
from cdbench.run import forbidden_modules
print("FORBIDDEN", forbidden_modules())
"""

_REF_ONLY = """
import sys
sys.path.insert(0, {root!r})
import importlib, pkgutil, cdbench.reference as r
for m in pkgutil.iter_modules(r.__path__):
    importlib.import_module("cdbench.reference." + m.name)
print("PORT", sorted({{m.split(".")[0] for m in sys.modules}}
                     & {{"coordinatedescent_jl_tpu_torch", "jax", "jaxlib",
                        "coordinatedescent_jl_tpu"}}))
"""


def _python(code: str) -> str:
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax_and_the_reference_none_of_the_port(cell):
    out = _python(_IMPORTS.format(root=str(ROOT), cell=cell))
    assert "FORBIDDEN []" in out


def test_the_reference_imports_nothing_of_the_port():
    assert "PORT []" in _python(_REF_ONLY.format(root=str(ROOT)))


def test_the_run_fails_without_a_card_and_prints_no_result():
    res = subprocess.run(
        [sys.executable, "-m", "cdbench.run", "--workload", CELLS[0],
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


# -- the timed path broken underneath: the run must come out not correct --

def _unchanged(entry):
    """The step returns its state unchanged: a solver its start (zeros),
    a polish its input."""
    import coordinatedescent_jl_tpu_torch as tcd

    if entry == "lasso_path":
        def f(*a, **k):
            path = tcd.models.lasso_path.lasso_path(*a, **k)
            return path._replace(beta_path=torch.zeros_like(path.beta_path))
    elif entry == "locpolyl1":
        def f(*a, **k):
            out, out_r = tcd.models.varying_coefficient.locpolyl1(*a, **k)
            return torch.zeros_like(out), out_r
    else:                                   # polish_lasso, polish_group_lasso
        real = getattr(tcd.models.polish, entry)

        def f(X, y, beta, *a, **k):
            res = real(X, y, beta, *a, **k)
            return res._replace(beta=beta.to(torch.float64))
    return f


def _half_left_out(entry):
    """Half of the batch (every second λ point or grid point) left out and
    filled with the mean of its neighbours."""
    import coordinatedescent_jl_tpu_torch as tcd

    def fill(B):                 # rows are the batch
        B = B.clone()
        for j in range(1, B.shape[0], 2):
            B[j] = B[j - 1] if j + 1 >= B.shape[0] else 0.5 * (B[j - 1]
                                                                + B[j + 1])
        return B

    if entry == "lasso_path":
        def f(*a, **k):
            path = tcd.models.lasso_path.lasso_path(*a, **k)
            return path._replace(beta_path=fill(path.beta_path))
    else:
        def f(*a, **k):
            out, out_r = tcd.models.varying_coefficient.locpolyl1(*a, **k)
            return fill(out.T).T, out_r
    return f


def _altered(entry):
    """The answer altered where it is produced: its largest coefficient
    1 % off."""
    import coordinatedescent_jl_tpu_torch as tcd

    real = {"lasso_path": tcd.models.lasso_path.lasso_path,
            "locpolyl1": tcd.models.varying_coefficient.locpolyl1}.get(
        entry) or getattr(tcd.models.polish, entry)

    def bump(B):
        B = B.clone()
        flat = B.reshape(-1)
        flat[torch.argmax(torch.abs(flat))] *= 1.01
        return B

    def f(*a, **k):
        res = real(*a, **k)
        if entry == "lasso_path":
            return res._replace(beta_path=bump(res.beta_path))
        if entry == "locpolyl1":
            return bump(res[0]), res[1]
        return res._replace(beta=bump(res.beta))
    return f


def _solve_off(entry):
    """The float32 stage's answer off by a relative 1e-4, as a solve whose
    products ran in TF32 reads; the float64 polish that follows repairs
    it."""
    import coordinatedescent_jl_tpu_torch as tcd

    real = getattr(tcd, entry)

    def f(*a, **k):
        sol = real(*a, **k)
        return sol._replace(x=sol.x * (1 + 1e-4))
    return f


_ENTRY = {"lasso_path100": "lasso_path", "vc_grid1000": "locpolyl1",
          "lasso_solve_polish": "polish_lasso",
          "group_lasso_g8": "polish_group_lasso"}
_FAULTS = [(c, f) for c in CELLS for f in ("unchanged", "altered")] + [
    (c, "half_left_out") for c in ("lasso_path100", "vc_grid1000")]
_SOLVE_ENTRY = {"lasso_solve_polish": "lasso", "group_lasso_g8": "group_lasso"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_tiny_run_is_correct(cell):
    rec = tiny_run(cell)
    assert rec["correct"], rec["checks"]
    assert rec["failed"] == 0 and len(rec["problems"]) == 1


@pytest.mark.parametrize("cell,fault", _FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    import coordinatedescent_jl_tpu_torch as tcd

    entry = _ENTRY[cell]
    make = {"unchanged": _unchanged, "half_left_out": _half_left_out,
            "altered": _altered}[fault]
    monkeypatch.setattr(tcd, entry, make(entry))
    rec = tiny_run(cell)
    assert not rec["correct"], rec["checks"]
    assert rec["failed"] >= 1


@pytest.mark.parametrize("cell", sorted(_SOLVE_ENTRY))
def test_a_less_precise_solve_before_the_polish_is_not_correct(monkeypatch,
                                                               cell):
    import coordinatedescent_jl_tpu_torch as tcd

    entry = _SOLVE_ENTRY[cell]
    monkeypatch.setattr(tcd, entry, _solve_off(entry))
    rec = tiny_run(cell)
    chk = rec["checks"]
    assert not rec["correct"] and rec["failed"] >= 1, chk
    # the polish repaired the start: only the solve's own number sees it
    assert chk["polish_err"]["value"] <= chk["polish_err"]["limit"], chk
    assert chk["solve_err"]["value"] > chk["solve_err"]["limit"], chk


def test_every_fit_that_falls_back_to_the_scan_is_judged(monkeypatch):
    """A fit that the batched grid did not certify (the scan's answer, which
    carries no certificate) is judged even where the seed's sample and the
    window's end leave it out: here a wrong one turns ``correct`` false."""
    import coordinatedescent_jl_tpu_torch as tcd
    from cdbench import data
    from cdbench.tests.tiny import tiny

    cell, cfg, traffic = tiny("vc_grid1000")
    seed = 20_261_018_7
    chk = traffic["check"]
    keep = set(data.sample_indices(seed, chk["span"], chk["problems"]))
    j0 = min(set(range(chk["span"] + 1)) - keep)
    calls = []

    def fake(X, z, y, zgrid, degree, kernel, lam0, *a, stats=None, **k):
        # the plain reference's answer, fast; the (j0 + 2)-th call (the
        # first is the warm-up) falls back to the scan and answers wrong
        calls.append(1)
        out = vc_reference(X, z, y, zgrid, degree, kernel.h,
                           lam0).to(torch.float32)
        fell = len(calls) == j0 + 2
        stats.update(used_batched=True, batched_certified=not fell)
        return (out * 1.01 if fell else out), None

    monkeypatch.setattr(tcd, "locpolyl1", fake)
    rec = run.run_cell(cell, cfg, traffic, seed, 0.5, False,
                       torch.device("cpu"), 0.0)
    assert len(rec["problems"]) > j0 + 1          # neither drawn nor last
    assert j0 in rec["per_problem"] and not rec["correct"], rec["checks"]
    assert rec["failed"] == 1
