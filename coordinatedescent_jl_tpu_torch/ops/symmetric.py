"""Symmetric-matrix coordinate support (counterpart of
``coordinatedescent_jl_tpu/ops/symmetric.py``): a symmetric ``p × p``
matrix optimized over its ``q = p(p+1)/2`` lower-triangle coordinates,
where packed coordinate ``k ↔ (i, j)`` sets both ``M[i, j]`` and
``M[j, i]``.  The iterate is the packed vector, solved by the ordinary
block engine; pack and unpack are one gather / scatter each at the
boundary.  Coordinate order is the packed lower triangle, column-major:
``(0,0), (1,0), …, (p−1,0), (1,1), …``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.options import CDOptions


def sym_num_coordinates(p: int) -> int:
    """Number of packed coordinates of a symmetric ``p × p`` iterate,
    ``p(p+1)/2``."""
    return p * (p + 1) // 2


def sym_indices(p: int) -> torch.Tensor:
    """``(q, 2)`` int64 tensor of ``(row, col)`` pairs (row ≥ col) of each
    packed coordinate, lower triangle, column-major."""
    iu = np.triu_indices(p)
    # the upper triangle row-major is the lower triangle column-major once
    # (row, col) are swapped
    return torch.as_tensor(np.stack([iu[1], iu[0]], axis=1), dtype=torch.int64)


def sym_pack(M) -> torch.Tensor:
    """Pack a symmetric ``(p, p)`` matrix into its ``(q,)`` coordinate
    vector."""
    M = torch.as_tensor(M)
    ij = sym_indices(M.shape[0]).to(M.device)
    return M[ij[:, 0], ij[:, 1]]


def sym_unpack(v, p: int) -> torch.Tensor:
    """The full symmetric ``(p, p)`` matrix of a ``(q,)`` packed vector
    (coordinate ``k`` sets both ``M[i, j]`` and ``M[j, i]``)."""
    v = torch.as_tensor(v)
    ij = sym_indices(p).to(v.device)
    M = torch.zeros((p, p), dtype=v.dtype, device=v.device)
    M[ij[:, 0], ij[:, 1]] = v
    eye = torch.eye(p, dtype=torch.bool, device=v.device)
    return torch.where(eye, M, M + M.T)


def symmetric_coordinate_descent(M0, loss, penalty, options=None, *,
                                 seed: int = 0, key=None, device=None):
    """Coordinate descent over a symmetric-matrix iterate: ``M0`` is the
    symmetric ``(p, p)`` start, ``loss`` and ``penalty`` are over the
    ``q = p(p+1)/2`` packed coordinates.  Packs ``M0``, runs
    ``coordinate_descent`` on ``device`` (``None``: the GPU, raising when
    there is none; ``"cpu"`` for the CPU) and unpacks.  Returns ``(M,
    residuals)`` with ``M`` the full symmetric solution."""
    from .block_cd import coordinate_descent

    if options is None:
        options = CDOptions()
    M0 = torch.as_tensor(M0)
    v, r = coordinate_descent(sym_pack(M0), loss, penalty, options,
                              seed=seed, key=key, device=device)
    return sym_unpack(v, M0.shape[0]), r
