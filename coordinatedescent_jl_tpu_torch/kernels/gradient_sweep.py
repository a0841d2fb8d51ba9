"""The gradient sweeps ``c = Xw'r``: K2, the restricted sweep
(``csrc/gradient_sweep.cu``), and K5, the dense sweep
(``csrc/dense_sweep.cu``), with their plain twins.

K2 replaces ``coordinatedescent_jl_tpu/ops/pallas_block.py:restricted_gradient_sweep``
(kernel ``_make_rsweep_kernel``): ``c[b] = Xw_b'r`` only for the blocks
with ``need[b]``, the others keep ``c_prev``.  The needed blocks are
ordered first by a stable argsort of ``~need`` on the device; the kernel's
grid is (needed-block slot, row chunk) into a partials buffer, and a
second kernel adds each block's partials in chunk order into a clone of
``c_prev``.  It is bounded by device-memory bandwidth (every needed block
is read once).

K5 replaces ``pallas_block.py:fused_gradient_sweep`` (kernel
``_make_sweep_kernel``): ``c = Xw'r`` for every column, X streamed once,
in two instantiations of one kernel —

- :func:`fused_gradient_sweep`: the blocked ``(nb, n, B)`` layout, one
  dtype throughout (the engine's dense refresh, ``_full_gradient_c``);
- :func:`grad_f64`: the dense ``(n, p)`` float32 design, float64 ``r``,
  float64 accumulation and output (the certificate of the f64 polish and
  the compensated gaps).

The grid is (column tile, row chunk) into a partials buffer, added per
column in chunk order by a second kernel; bounded by device-memory
bandwidth (X read once).

``LAUNCHES`` (K2), ``LAUNCHES_DENSE`` (K5 blocked) and ``LAUNCHES_F64``
(K5 f64) count the wrapper calls that launched a kernel.
"""

from __future__ import annotations

import torch

from . import _build
from ..utils import host

LAUNCHES = 0
LAUNCHES_DENSE = 0
LAUNCHES_F64 = 0
_ROW_CHUNK = 256
# columns per float64 chunk of grad_f64_plain: bounds the f64 copy of X to
# n·8192·8 bytes (655 MB at n = 10K) instead of a whole f64 X
_F64_COLS = 8192


def restricted_gradient_sweep(Xwb, r, need, c_prev, *, n_need=None):
    """Refresh ``c[b] = Xw_b'r`` for the blocks with ``need[b]``.  ``n_need``
    (the host count of needed blocks) saves a host read when the caller
    already has it.  CUDA tensors launch the kernels (or raise); CPU
    tensors run the plain twin."""
    if not Xwb.is_cuda:
        return restricted_gradient_sweep_plain(Xwb, r, need, c_prev)
    global LAUNCHES
    req = _build.require
    nb, n, B = Xwb.shape
    dt = Xwb.dtype
    req(dt in (torch.float32, torch.float64),
        f"gradient-sweep kernel: dtype {dt} (float32/float64 only)")
    req(B <= 1024, f"gradient-sweep kernel: block width {B} > 1024")
    for name, t, shape in (("Xwb", Xwb, (nb, n, B)), ("r", r, (n,)),
                           ("c_prev", c_prev, (nb, B))):
        req(t.is_cuda and t.device == Xwb.device and t.dtype == dt,
            f"gradient-sweep kernel: {name} must be {dt} on {Xwb.device}")
        req(tuple(t.shape) == shape and t.is_contiguous(),
            f"gradient-sweep kernel: {name} must be contiguous {shape}")
    req(need.is_cuda and need.dtype == torch.bool and need.shape == (nb,),
        "gradient-sweep kernel: need must be a (nb,) bool CUDA tensor")
    if n_need is None:
        n_need = host.item(torch.sum(need))
    out = c_prev.clone()
    if n_need == 0:
        return out
    order = torch.argsort((~need).to(torch.int32), stable=True).to(
        torch.int32)
    nr = -(-n // _ROW_CHUNK)
    part = torch.empty((n_need, nr, B), dtype=dt, device=Xwb.device)
    lib = _build.library()
    fn = lib.cdt_rsweep_f32 if dt == torch.float32 else lib.cdt_rsweep_f64
    P = _build.ptr
    err = fn(P(Xwb), P(r), P(order), P(part), P(out), int(n_need), n, B,
             _ROW_CHUNK, _build.stream())
    _build.check(err, "rsweep")
    LAUNCHES += 1
    return out


def restricted_gradient_sweep_plain(Xwb, r, need, c_prev):
    """Plain twin: the needed blocks' ``Xw_b'r``, the others from
    ``c_prev``."""
    out = c_prev.clone()
    idx = torch.nonzero(need).reshape(-1)
    out[idx] = torch.matmul(r, Xwb[idx])
    return out


def _dense_sweep(fn, X, r, out, nb: int, n: int, W: int, name: str):
    """Launch one K5 instantiation: ``out`` (nb·W columns) ← X'r over
    row stride ``W``."""
    nr = -(-n // _ROW_CHUNK)
    _build.require(nr <= 65535, f"{name} kernel: n = {n} is too tall")
    part = torch.empty((nr, nb * W), dtype=out.dtype, device=out.device)
    P = _build.ptr
    err = fn(P(X), P(r), P(part), P(out), nb, n, W, _ROW_CHUNK,
             _build.stream())
    _build.check(err, name)


def _require_sweep_inputs(name, X, r, xdtypes, rdtype, n):
    req = _build.require
    req(X.dtype in xdtypes, f"{name} kernel: X dtype {X.dtype}")
    req(X.is_contiguous(), f"{name} kernel: X must be contiguous")
    req(r.is_cuda and r.device == X.device and r.dtype == rdtype,
        f"{name} kernel: r must be {rdtype} on {X.device}")
    req(tuple(r.shape) == (n,) and r.is_contiguous(),
        f"{name} kernel: r must be contiguous ({n},)")


def fused_gradient_sweep(Xwb, r):
    """Blocked ``c[b] = Xw_b'r`` for every block, ``(nb, B)``.  CUDA tensors
    launch K5 (or raise); CPU tensors run the plain twin."""
    if not Xwb.is_cuda:
        return fused_gradient_sweep_plain(Xwb, r)
    global LAUNCHES_DENSE
    nb, n, B = Xwb.shape
    _require_sweep_inputs("dense-sweep", Xwb, r,
                          (torch.float32, torch.float64), Xwb.dtype, n)
    out = torch.empty((nb, B), dtype=Xwb.dtype, device=Xwb.device)
    lib = _build.library()
    fn = (lib.cdt_dense_sweep_f32 if Xwb.dtype == torch.float32
          else lib.cdt_dense_sweep_f64)
    _dense_sweep(fn, Xwb, r, out, nb, n, B, "dense_sweep")
    LAUNCHES_DENSE += 1
    return out


def fused_gradient_sweep_plain(Xwb, r):
    """Plain twin: one batched product straight off the ``(nb, n, B)``
    layout (``torch.einsum`` would first copy the whole blocked design into
    an ``(n, nb·B)`` layout)."""
    return torch.matmul(r, Xwb)


def grad_f64(X, r64):
    """``X'r`` with float64 accumulation, ``(p,)`` float64, for a dense
    ``(n, p)`` design ``X`` (float32 or float64) and a float64 ``r``.  CUDA
    tensors launch K5's f64-accumulating instantiation (or raise); CPU
    tensors run the plain twin."""
    if not X.is_cuda:
        return grad_f64_plain(X, r64)
    global LAUNCHES_F64
    n, p = X.shape
    _require_sweep_inputs("grad_f64", X, r64,
                          (torch.float32, torch.float64), torch.float64, n)
    out = torch.empty((p,), dtype=torch.float64, device=X.device)
    lib = _build.library()
    fn = lib.cdt_grad64_f32 if X.dtype == torch.float32 else \
        lib.cdt_grad64_f64
    _dense_sweep(fn, X, r64, out, 1, n, p, "grad64")
    LAUNCHES_F64 += 1
    return out


def grad_f64_plain(X, r64):
    """Plain twin: ``r'X`` with X widened to float64 a column chunk at a
    time."""
    p = X.shape[1]
    return torch.cat([r64 @ X[:, j:j + _F64_COLS].to(torch.float64)
                      for j in range(0, p, _F64_COLS)])
