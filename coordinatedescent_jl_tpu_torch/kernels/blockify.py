"""The design's set-up copy BL (``csrc/blockify.cu``): the zero-padded
column-blocked design ``Xb (nb, n, B)`` and its columns' sums of squares
(or norms) in one launch.

Replaces no Pallas kernel: the JAX package's set-up is ``jnp.pad`` +
reshape/transpose + a ``jnp.sum`` under XLA
(``coordinatedescent_jl_tpu/ops/block_cd.py::build_blocked``).  The plain
twin :func:`blockify_plain` is the port's eager sequence
(``ops/block_cd.py``'s ``_pad_to_blocks`` and ``_blockify_cols``, then
``torch.sum(Xb * Xb, dim=1)`` or ``vector_norm``): a padded copy, a strided
permute copy and a squared design-sized temporary read back, ~28e9 B of
device traffic at 10,000 × 100,000 float32 where 8.0e9 B do.  The kernel is
bounded by those bytes (2.39 ms at 3.35 TB/s): one read of X and one write
of ``Xb``, each row of a block 16-byte loads and stores where the strides
and the base allow, the squares summed in float64 registers on the way and
rounded once to the design's dtype, the partials added in a fixed order
(no atomics: the same bits every run).  ``Xb`` is the twin's bit for bit,
the sums within one rounding of the exact sum.

``ops/block_cd.py::build_blocked`` (kinds ls and sqrt) and
``ops/group_cd.py::_build_group_problem`` (without row weights) take it
when the kernels are on; ``LAUNCHES`` counts the wrapper calls that
launched it (one a build on the card).
"""

from __future__ import annotations

import torch

from . import _build
from ..ops.block_cd import _blockify_cols, _pad_to_blocks
from ..utils import host

LAUNCHES = 0
_MAX_B = 1024      # csrc/blockify.cu BL_MAXB
_THREADS = 256     # csrc/blockify.cu BL_THREADS
_WAVES = 4         # row chunks enough for this many waves of CTAs
_MIN_ROWS = 64     # the fewest rows of a chunk (its partials cost traffic)
_MAX_CHUNKS = 65535


def plan_rows(nb: int, n: int, lanes: int, sms: int) -> int:
    """Rows of a CTA's chunk for ``nb`` blocks of ``n`` rows, ``lanes``
    threads a block row (``B / 4`` in float32 on the 16-byte path), on a
    card with ``sms`` multiprocessors: a CTA copies ``_THREADS // lanes``
    adjacent blocks (at least one), and the rows split until the grid
    gives ``_WAVES`` waves of 8 CTAs an SM, never below ``_MIN_ROWS`` rows
    a chunk.  One chunk (no partials, one launch) where the blocks alone
    give that many."""
    ctas = -(-nb // max(1, _THREADS // lanes))
    want = _WAVES * (2048 // _THREADS) * sms
    nr = min(max(1, -(-want // ctas)), max(1, n // _MIN_ROWS), _MAX_CHUNKS)
    return -(-n // nr)


def blockify_plain(X, B: int, norm: bool = False):
    """Plain twin: ``(Xb, s)``, ``Xb`` the ``(nb, n, B)`` blocks of ``X``
    zero-padded to whole blocks (a view of ``X`` where they are laid out
    already), ``s (nb, B)`` the columns' ``Σ x²``, or their norms with
    ``norm``."""
    Xb = _blockify_cols(_pad_to_blocks(X, B), B)
    if norm:
        return Xb, torch.linalg.vector_norm(Xb, dim=1)
    return Xb, torch.sum(Xb * Xb, dim=1)


def blockify(X, B: int, norm: bool = False):
    """:func:`blockify_plain` in one launch: CUDA tensors launch the kernel
    (or raise ``ValueError`` on a dtype or width it does not take), CPU
    tensors run the plain twin.  ``X`` may be any strided ``(n, p)`` view
    (a column slice needs no copy first); ``Xb`` is always a new tensor.
    Marked ``cdt#design_copy`` with the bytes it writes, as the twin's
    copies are."""
    if not X.is_cuda:
        return blockify_plain(X, B, norm)
    global LAUNCHES
    req = _build.require
    dt = X.dtype
    req(dt in (torch.float32, torch.float64),
        "blockify kernel: dtype {} (float32/float64 only)", dt)
    req(X.dim() == 2 and X.shape[0] >= 1 and X.shape[1] >= 1,
        "blockify kernel: X must be a non-empty (n, p) matrix, not {}",
        tuple(X.shape))
    req(1 <= B <= _MAX_B, "blockify kernel: block width {} (1 to {})", B,
        _MAX_B)
    n, p = X.shape
    nb = -(-p // B)
    item = X.element_size()
    V = 16 // item
    ld, cs = X.stride()
    Xb = torch.empty((nb, n, B), dtype=dt, device=X.device)
    out = torch.empty((nb, B), dtype=dt, device=X.device)
    vec = (B % V == 0 and p % V == 0 and ld % V == 0 and cs == 1
           and X.data_ptr() % 16 == 0)
    R = plan_rows(nb, n, B // V if vec else B, _build.sm_count(X.device))
    nr = -(-n // R)
    part = (torch.empty((nb, nr, B), dtype=torch.float64, device=X.device)
            if nr > 1 else None)
    lib = _build.library()
    fn = lib.cdt_blockify_f32 if dt == torch.float32 else \
        lib.cdt_blockify_f64
    P = _build.ptr
    with host.mark("design_copy", bytes=nb * n * B * item):
        err = fn(P(X), ld, cs, P(Xb), P(part), P(out), n, p, B, R, int(vec),
                 int(norm), _build.stream(X.device))
    _build.check(err, "blockify")
    LAUNCHES += 1
    if _build.NAN_CHECK:
        _build.check_nans("blockify", out)
    return Xb, out

