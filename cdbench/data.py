"""Inputs of every cell, made on the device from ``--seed``.

The constructions are the project's own bench problems (the port's
``profile_paths.bench_problem``, ``group_bench_problem`` and
``vc_bench_problem``, copied here so that a change to the port cannot move
the yardstick): a dense Gaussian design, then a pool of responses, one a
problem, each with a fresh planted support and fresh noise.  Everything
is drawn from ``torch.Generator`` objects on the device, in a few large
calls, in float32 (the precision the configurations state).
"""

from __future__ import annotations

import numpy as np
import torch

# responses made per GEMM against X: bounds the temporaries to
# p x _CHUNK floats (200 MB at p = 100K)
_CHUNK = 512


def subseed(seed: int, stream: int) -> int:
    """A 63-bit seed for one of a run's random streams (design, responses,
    noise, sample), from the run's ``--seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(subseed(seed, stream))


def dtype_of(cfg) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[cfg["dtype"]]


def gauss_design(cfg, seed: int, dev) -> torch.Tensor:
    """Dense ``(n, p)`` design with N(0, 1) entries (upstream
    ``benchmark/cd_bench.jl``'s ``randn(n, p)``), one call."""
    g = generator(seed, 0, dev)
    return torch.randn((cfg["n"], cfg["p"]), generator=g, device=dev,
                       dtype=dtype_of(cfg))


def _add_noise(Y, sd: float, g):
    Y += sd * torch.randn(Y.shape, generator=g, device=Y.device,
                          dtype=Y.dtype)
    return Y


def scattered_responses(X, m: int, s: int, noise: float, seed: int):
    """``m`` responses ``(m, n)``: each ``X β + noise·N(0, 1)`` with ``s``
    planted coordinates drawn without replacement and N(0, 1) values (the
    bench problem's construction)."""
    n, p = X.shape
    dev = X.device
    g = generator(seed, 1, dev)
    Y = torch.empty((m, n), dtype=X.dtype, device=dev)
    for a in range(0, m, _CHUNK):
        k = min(_CHUNK, m - a)
        # s distinct columns a response: the s largest of p uniforms
        sup = torch.topk(torch.rand((k, p), generator=g, device=dev), s,
                         dim=1).indices
        Bt = torch.zeros((k, p), dtype=X.dtype, device=dev)
        Bt.scatter_(1, sup, torch.randn((k, s), generator=g, device=dev,
                                        dtype=X.dtype))
        Y[a:a + k] = Bt @ X.T
    return _add_noise(Y, noise, g)


def group_responses(X, m: int, G: int, n_act: int, noise: float, seed: int):
    """``m`` responses ``(m, n)``: ``n_act`` of the ``p / G`` contiguous
    groups of ``G`` columns set to 1.0, plus ``noise·N(0, 1)`` (bench.py's
    group section)."""
    n, p = X.shape
    dev = X.device
    g = generator(seed, 2, dev)
    ng = p // G
    Y = torch.empty((m, n), dtype=X.dtype, device=dev)
    for a in range(0, m, _CHUNK):
        k = min(_CHUNK, m - a)
        grp = torch.topk(torch.rand((k, ng), generator=g, device=dev), n_act,
                         dim=1).indices
        Bg = torch.zeros((k, ng), dtype=X.dtype, device=dev)
        Bg.scatter_(1, grp, 1.0)
        Bt = torch.zeros((k, p), dtype=X.dtype, device=dev)
        Bt[:, :ng * G] = Bg.repeat_interleave(G, dim=1)
        Y[a:a + k] = Bt @ X.T
    return _add_noise(Y, noise, g)


def lambda_max(X, Y) -> torch.Tensor:
    """``max_j |X_j'y| / n`` for every response (rows of ``Y``), in the
    design's precision with full-precision matmuls."""
    n = X.shape[0]
    return torch.cat([torch.amax(torch.abs(Y[a:a + _CHUNK] @ X), dim=1)
                      for a in range(0, Y.shape[0], _CHUNK)]) / n


def group_lambda_max(X, Y, G: int) -> torch.Tensor:
    """``max_g ‖X_g'y‖₂ / n`` over the contiguous groups of ``G`` columns."""
    n, p = X.shape
    out = []
    for a in range(0, Y.shape[0], _CHUNK):
        C = Y[a:a + _CHUNK] @ X
        out.append(torch.amax(torch.linalg.vector_norm(
            C[:, :p // G * G].reshape(C.shape[0], -1, G), dim=2), dim=1))
    return torch.cat(out) / n


def vc_problems(cfg, m: int, noise: float, seed: int, dev):
    """``m`` varying-coefficient data sets (bench.py:480-611's
    construction), each its own: ``X (m, n, p)`` N(0, 1), ``z (m, n)``
    U(0, 1) and ``y = sin(2πz)·X[:, 0] + noise·N(0, 1)``."""
    g = generator(seed, 3, dev)
    dt = dtype_of(cfg)
    n, p = cfg["n"], cfg["p"]
    X = torch.randn((m, n, p), generator=g, device=dev, dtype=dt)
    z = torch.rand((m, n), generator=g, device=dev, dtype=dt)
    Y = torch.sin(2 * np.pi * z) * X[:, :, 0]
    return X, z, _add_noise(Y, noise, g)


def sample_indices(seed: int, span: int, k: int) -> list[int]:
    """``k`` distinct problem indices below ``span``, drawn from the seed:
    the problems whose outputs are kept for the comparison (the last
    problem of the window is kept besides)."""
    rng = np.random.default_rng(subseed(seed, 5))
    return sorted(int(i) for i in rng.choice(span, size=min(k, span),
                                             replace=False))
