"""The least time the card allows each counted kernel launch.

A launch's least time is the larger of its bytes over the card's
published memory rate and its operations over its published float32 rate
(NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit; each
run prints the card's own power limit beside the shares).  Bytes count
what the computation at that shape needs, whatever computes it: each
input read once and each output written once; a kernel's own scratch
(partial sums between slices, grid partials) is not counted.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM
PEAK_F32_FLOPS = 67e12         # float32 outside the tensor cores
F32 = 4


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def k5_bytes(nb: int, n: int, B: int = 128, item: int = F32) -> int:
    """K5, the blocked sweep ``c[b] = X_b' r`` over ``nb`` blocks of ``n``
    rows and ``B`` columns: X and r read, c written."""
    return item * (nb * n * B + n + nb * B)


def k5_flops(nb: int, n: int, B: int = 128) -> int:
    """One multiply and one add for each element of X."""
    return 2 * nb * n * B


# K3 / K4, per coordinate of the nb x B block layout: the float32 rows
# the phase reads and writes (csrc/check.cu's arguments).  Phase A reads
# c, beta, adiag, lamw, validf, xwnorm and writes the drift bound; per
# block row it reads the drift and writes need, use-bound, candidate and
# active.  Phase B reads c, beta, bound, adiag, lamw, validf, xwnorm;
# per block row ubf and candf in, active out.  Both read the 5 scalars of
# scal and write maxh.
_CHECK_ROWS = {"a": (7, 5), "b": (7, 3)}
# operations per coordinate: the prox step and its noise floor (B), plus
# the screen's and the stale certificate's terms (A); the kernels are
# bound by bytes and by latency long before these
_CHECK_FLOPS = {"a": 16, "b": 8}


def check_bytes(phase: str, nb: int, B: int = 128) -> int:
    per_coord, per_row = _CHECK_ROWS[phase]
    return F32 * (per_coord * nb * B + per_row * nb + 5 + 1)


def check_flops(phase: str, nb: int, B: int = 128) -> int:
    return _CHECK_FLOPS[phase] * nb * B
