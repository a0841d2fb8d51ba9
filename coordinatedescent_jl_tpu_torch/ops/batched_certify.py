"""Lane primitives of the batched certify/refine execution (counterpart of
``coordinatedescent_jl_tpu/ops/batched_certify.py``; see that module for
the scheme: many related problem instances, "lanes", are solved in
lockstep, certified with one shared order-independent KKT sweep per X
read, and only the uncertified lanes are refined).

The products here are plain ``torch.matmul`` (the JAX package computes
them outside any Pallas kernel) and must run with full-f32 matmuls
(``block_cd.full_f32_matmuls``): TF32 puts ~1e-3 relative error into the
certify sweep and no lane certifies at ``opt_tol = 1e-6``.
``union_block_fista``'s ``lax.scan`` loops are host loops of small
products (8 sweeps × blocks × ``block_iters`` FISTA steps per round).
The JAX module's ``run_chunked_segments`` (its :161, the host segment
loop of every ``scan_chunk`` entry point) is not ported: it went with
``scan_chunk``, which the port takes and ignores.
"""

from __future__ import annotations

import numpy as np
import torch

from .block_cd import _np_dtype, noise_floor_mask
from .prox import soft_threshold
from ..utils.options import CDOptions


def kkt_violation_lanes(B, R, thrw, X, adiag, xnorm):
    """Per-lane KKT violation magnitudes ``|prox-step|`` of a batch of
    iterates against ``X``: ``B``/``thrw`` are ``(k, p)``, ``R`` ``(k, n)``;
    returns the noise-floor-masked ``H`` of shape ``(k, p)``.  The prox step
    is written as ``c/a − t·sign(z)`` on the un-thresholded branch (the
    literal ``|soft(B + c/a, t) − B|`` cancels at scale ``|B|``)."""
    Cg = torch.matmul(R, X)
    g = Cg / adiag[None]
    t = thrw / adiag[None]
    zv = B + g
    H = torch.abs(torch.where(torch.abs(zv) > t, g - t * torch.sign(zv), -B))
    if B.dtype.itemsize < 8:
        eps = torch.finfo(B.dtype).eps
        rnorm = torch.sqrt(torch.sum(R * R, dim=1))
        return noise_floor_mask(H, B,
                                4 * eps * rnorm[:, None] / xnorm[None, :])
    return noise_floor_mask(H, B)


def union_priority(B, H, cert, hi):
    """Two-tier union-working-set priority per column: support coordinates
    of uncertified lanes strictly above violations, ranked by ``|B|``
    within the support tier and by ``H`` within the violation tier.  ``hi``
    is ``2·max(H over uncertified lanes) + 1``."""
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    Habs = torch.where(cert[:, None], zero, H)
    Bmag = torch.amax(torch.where(cert[:, None], zero, torch.abs(B)), dim=0)
    anynz = torch.any((B != 0) & ~cert[:, None], dim=0)
    return torch.where(anynz, hi * (1.0 + Bmag / (1.0 + Bmag)),
                       torch.amax(Habs, dim=0))


def union_block_fista(Ks, thr_full, Bs0, cs0, cert, opts: CDOptions,
                      n_sweeps: int = 8):
    """Cyclic block-FISTA refinement over a gathered union working set:
    ``block_size``-wide blocks of the union Gram ``Ks (Cp, Cp)`` with
    per-block Gershgorin majorizers and cross-block gradient maintenance.
    ``Bs0``/``cs0`` are ``(k, Cp)`` lane coefficients and gradients
    ``Xs'R``; certified lanes (``cert``) are frozen.  Returns the refined
    coefficients.  The FISTA momentum sequence is the same for every step
    and block, so it is computed once on the host in the working dtype."""
    Cp = Ks.shape[0]
    Bb = int(opts.block_size)
    ncb = Cp // Bb
    Kdiag = [Ks[o:o + Bb, o:o + Bb] for o in range(0, Cp, Bb)]
    Lb = torch.clamp_min(torch.stack([
        torch.amax(torch.sum(torch.abs(K), dim=1)) for K in Kdiag]), 1e-30)
    npdt = _np_dtype(Bs0.dtype).type
    coefs, t = [], npdt(1)
    for _ in range(opts.block_iters):
        t_new = npdt(0.5) * (npdt(1) + np.sqrt(npdt(1) + npdt(4) * t * t))
        coefs.append(float((t - npdt(1)) / t_new))
        t = t_new
    frozen = cert[:, None]
    bs, cs = Bs0.clone(), cs0
    for _ in range(n_sweeps):
        for b in range(ncb):
            o = b * Bb
            bs_b = bs[:, o:o + Bb]
            cs_b = cs[:, o:o + Bb]
            thr_b = thr_full[:, o:o + Bb]
            Kbb, L = Kdiag[b], Lb[b]
            thr_L = thr_b / L
            z = v = bs_b
            for coef in coefs:
                gv = cs_b - torch.matmul(v - bs_b, Kbb)
                z_new = soft_threshold(v + gv / L, thr_L)
                v = z_new + coef * (z_new - z)
                z = z_new
            b_new = torch.where(frozen, bs_b, z)
            d = b_new - bs_b
            cs = cs - torch.matmul(d, Ks[o:o + Bb, :])
            bs[:, o:o + Bb] = b_new
    return bs


def stall_escape_update(cert, best, stall, escaped, mx, patience, tol,
                        frozen=None):
    """Per-lane f32 stall escape: a lane whose certificate max ``mx`` has
    not improved for ``patience`` rounds is accepted when it sits on a
    finite plateau within ``4·tol`` (the scan exits such points through its
    stall detector); a lane stuck far from optimality stays uncertified so
    the scan fallback fires.  Returns the updated
    ``(cert, best, stall, escaped)``; ``escaped`` accumulates the lanes
    certified through the escape rather than the strict ``mx < tol``."""
    improved = mx < best
    stall = torch.where(cert, stall,
                        torch.where(improved, torch.zeros_like(stall),
                                    stall + 1))
    best = torch.minimum(best, mx)
    stall_ok = (stall >= patience) & (mx < 4 * tol) & torch.isfinite(mx)
    strict = mx < tol
    escaped = escaped | (~cert & stall_ok & ~strict)
    cert = cert | strict | stall_ok
    if frozen is not None:
        cert = cert | frozen
    return cert, best, stall, escaped
