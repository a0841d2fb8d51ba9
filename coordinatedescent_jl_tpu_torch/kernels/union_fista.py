"""The batched path's union-block FISTA round (``csrc/union_fista.cu``).

Replaces no Pallas kernel: ``coordinatedescent_jl_tpu/ops/batched_certify.py
::union_block_fista`` is an XLA ``lax.scan``.  Its plain twin,
``ops/batched_certify.py::union_block_fista_plain``, runs the round as host
loops of eager products: 8 sweeps × ``Cp / block_size`` blocks ×
``block_iters`` FISTA steps of small eager launches (~14,700 device
operations a round at the batched path's ``Cp = 1,024``, blocks of 128 and
16 steps), every one a 128-wide GEMV or an elementwise op.  Here the whole
round is one launch: one CTA a lane, the lane's coefficients, gradients and
thresholds in shared memory for the round, each block's Gram tile in
registers, the cross-block gradient update streamed from L2.  The
arithmetic is the plain round's, operation for operation, with its sums in
another order.  It is bounded by the chain of dependent FISTA steps (1,024
a round at that shape), not by bytes or flops; the host's dispatch, which
bounded the plain round, is off that chain.

``LAUNCHES`` counts the wrapper calls that launched the kernel (one a
refine round on the card).
"""

from __future__ import annotations

import torch

from . import _build
from ..ops.batched_certify import union_block_fista_plain
from ..ops.prox import fista_momentum
from ..utils.options import CDOptions

LAUNCHES = 0
_MAX_B = 128       # widest block: the FISTA product covers 128 coordinates
_SCRATCH = 2048    # csrc/union_fista.cu UF_SCR


def smem_bytes(Cp: int, B: int, iters: int, itemsize: int) -> int:
    """Dynamic shared memory of one CTA (``csrc/union_fista.cu::uf_layout``,
    which refuses any other count): the lane's coefficients, gradients and
    thresholds, two step vectors and the block's change, the scratch, the
    blocks' majorizers, the momentum coefficients and 32 reduction slots,
    each array rounded up to 16 bytes."""
    V = 16 // itemsize

    def up(x):
        return -(-x // V) * V

    return itemsize * (3 * up(Cp) + 3 * _MAX_B + _SCRATCH + up(Cp // B)
                       + up(iters) + 32)


def require_inputs(Ks, thr_full, Bs0, cs0, cert, block_size: int):
    """The shapes, dtypes and layout the kernel takes (raises
    ``ValueError`` on any other): float32 or float64 throughout,
    ``Ks (Cp, Cp)``, ``thr_full``/``Bs0``/``cs0`` ``(k, Cp)``, ``cert
    (k,)`` bool, all contiguous and on one device; ``block_size`` at most
    128 and dividing ``Cp``."""
    req = _build.require
    k, Cp = Bs0.shape
    dt = Bs0.dtype
    req(dt in (torch.float32, torch.float64),
        "union-fista kernel: dtype {} (float32/float64 only)", dt)
    req(1 <= block_size <= _MAX_B,
        "union-fista kernel: block width {} (1 to {})", block_size, _MAX_B)
    req(Cp % block_size == 0,
        "union-fista kernel: Cp {} is not a multiple of the block width {}",
        Cp, block_size)
    for name, t, shape in (("Ks", Ks, (Cp, Cp)), ("thr_full", thr_full,
                                                  (k, Cp)),
                           ("Bs0", Bs0, (k, Cp)), ("cs0", cs0, (k, Cp))):
        req(t.device == Bs0.device and t.dtype == dt,
            "union-fista kernel: {} must be {} on {}", name, dt, Bs0.device)
        req(tuple(t.shape) == shape and t.is_contiguous(),
            "union-fista kernel: {} must be contiguous {}", name, shape)
    req(cert.device == Bs0.device and cert.dtype == torch.bool
        and tuple(cert.shape) == (k,) and cert.is_contiguous(),
        "union-fista kernel: cert must be a contiguous ({},) bool tensor "
        "on {}", k, Bs0.device)


def fused_union_fista(Ks, thr_full, Bs0, cs0, cert, opts: CDOptions,
                      n_sweeps: int = 8):
    """The refinement round of
    ``ops/batched_certify.py::union_block_fista`` in one launch; CUDA
    tensors launch the kernel (or raise), CPU tensors run the plain twin.
    Returns the refined ``(k, Cp)`` coefficients, a certified lane's row
    ``Bs0``'s."""
    if not Bs0.is_cuda:
        return union_block_fista_plain(Ks, thr_full, Bs0, cs0, cert, opts,
                                       n_sweeps)
    global LAUNCHES
    B = int(opts.block_size)
    iters = int(opts.block_iters)
    require_inputs(Ks, thr_full, Bs0, cs0, cert, B)
    k, Cp = Bs0.shape
    dt = Bs0.dtype
    item = Bs0.element_size()
    smem = smem_bytes(Cp, B, iters, item)
    _build.require(smem <= _build.smem_optin(Bs0.device),
                   "union-fista kernel: {} bytes of shared memory at Cp = "
                   "{} (the card allows {})", smem, Cp,
                   _build.smem_optin(Bs0.device))
    out = torch.empty_like(Bs0)
    mom = _build.momentum_table(fista_momentum(iters, dt), dt, Bs0.device)
    vec = Cp % (16 // item) == 0 and Ks.data_ptr() % 16 == 0
    lib = _build.library()
    fn = lib.cdt_union_fista_f32 if dt == torch.float32 else \
        lib.cdt_union_fista_f64
    P = _build.ptr
    err = fn(P(Ks), P(thr_full), P(Bs0), P(cs0), P(cert), P(mom), P(out), k,
             Cp, B, iters, int(n_sweeps), int(vec), smem,
             _build.stream(Bs0.device))
    _build.check(err, "union_fista")
    LAUNCHES += 1
    if _build.NAN_CHECK:
        _build.check_nans("union_fista", out)
    return out
