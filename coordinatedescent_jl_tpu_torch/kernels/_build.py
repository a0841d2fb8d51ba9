"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, and linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) that is loaded
with ``ctypes``.  The build runs at first use, on the machine
with the GPU, into ``build/kernels/`` at the root of the checkout; the
library's name carries a hash of the sources, so an edited source is
rebuilt.  Nothing here runs at import time.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises when it is not 0 (``cudaSuccess``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..utils import host

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas=-v"]
# the check kernels evaluate the plain path's elementwise formulas and
# must round each operation as PyTorch's separate kernels do: no
# contraction of a*b + c into one fused multiply-add
EXTRA_FLAGS = {"check.cu": ["-fmad=false"]}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# argument types of every C entry point (pointers and the stream as
# c_void_p: a plain int would be cut to 32 bits)
_SIGNATURES = {
    # X, Xw, Kb|0, lamw, border, active, corder, mom|0, beta_in, r_in,
    # rsqr_in, beta_out, r_out, maxh, rsqr_out, part_c|0, part_rs|0,
    # part_k|0, kred|0, nb, n, B, grid, rows, keep_x, keep_r, smem, cluster,
    # kind, ista, iters, lam0, n_scale, stream
    "cdt_active_pass": [_P] * 19 + [_I] * 12 + [_D, _D, _P],
    # cluster, grid, smem, barriers, src|0, bytes, stream (K1's launch probe)
    "cdt_probe_launch": [_I] * 4 + [_P, _I, _P],
    # host buffer of 132 x 8 int64 (a -DCDT_AP_STAMPS build only)
    "cdt_ap_stamps": [_P],
    # Xwb, r, order, part, out, n_need, n, B, R, stream
    "cdt_rsweep": [_P] * 5 + [_I] * 4 + [_P],
    # c, beta, drift, adiag, lamw, validf, xwnorm, scal, need, ub, cand,
    # bound, maxh, active, part|0, nb, B, screen, grid, cta, stream
    "cdt_check_a": [_P] * 15 + [_I] * 5 + [_P],
    # c, beta, bound, ubf, candf, adiag, lamw, validf, xwnorm, scal, maxh,
    # active, part|0, nb, B, grid, cta, stream
    "cdt_check_b": [_P] * 13 + [_I] * 4 + [_P],
    # phase_b, &ctas (int)
    "cdt_check_resident": [_I, _P],
    # stream (an empty launch of one CTA of the check's threads)
    "cdt_check_probe": [_P],
    # kind, smem, cluster, &count (int): K1's cluster occupancy
    "cdt_active_pass_clusters": [_I, _I, _I, _P],
    # cluster, &count (int): each K5 instantiation's cluster occupancy
    **{f"cdt_{k}_{d}_clusters": [_I, _P]
       for k in ("dense_sweep", "grad64") for d in ("f32", "f64")},
    # X, r, part|0, out, nb, n, W, split, rows, grid, cluster, stream (both
    # K5 instantiations)
    "cdt_dense_sweep": [_P] * 4 + [_I] * 7 + [_P],
    "cdt_grad64": [_P] * 4 + [_I] * 7 + [_P],
    # Ks, thr, Bs0, cs0, cert, mom, out, k, Cp, B, iters, n_sweeps, vec,
    # smem, stream
    "cdt_union_fista": [_P] * 7 + [_I] * 7 + [_P],
    # X, Xw, Kb, Lb, thr, valid, border, active, mom, beta_in, r_in,
    # beta_out, r_out, maxh, part_c, nb, n, B, G, grid, rows, keep_x,
    # keep_r, iters, wls, smem, stream
    "cdt_group_pass": [_P] * 15 + [_I] * 11 + [_P],
    # X, y, w, dpow, sc, Lt, adiag, xwnorm, thrw, B, cert, best, stall, esc,
    # mom, scratch|0, B_out, R, mx, cert_out, best_out, stall_out, esc_out,
    # k, n, p, q1, iters, route, patience, smem, tol, tol4, stream
    "cdt_vc_round": [_P] * 23 + [_I] * 8 + [_D, _D, _P],
}

_lib = None
build_seconds = 0.0
build_log = ""
# set by utils/profiling.py::debug_nans: the launches are ctypes calls that
# PyTorch's dispatcher never sees, so while it is on every wrapper checks
# its own outputs (check_nans); off, a launch pays one test of this flag
NAN_CHECK = False


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU (set CUDA_HOME or PATH)")


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    # CDT_NVCC_FLAGS: extra flags for a measurement build (kernel_ab.py
    # --stamps), part of the library's name
    flags = [*COMPILE_FLAGS, *os.environ.get("CDT_NVCC_FLAGS", "").split()]
    digest = hashlib.sha256(repr((flags, EXTRA_FLAGS)).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    out = BUILD_DIR / f"libcdt_kernels_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{out.stem}.{os.getpid()}"
        t0 = time.perf_counter()
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
        # one nvcc per source, all started together
        _run_all([[nvcc, *flags, *EXTRA_FLAGS.get(src.name, []),
                   "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources, objs)])
        tmp = BUILD_DIR / f"{tag}.so"
        _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, out)
        for obj in objs:
            obj.unlink()
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("", "_f32", "_f64"):
            fn = getattr(lib, f"{name}{suffix}", None)
            if fn is None:
                continue
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _run_all(cmds):
    """Run the commands in parallel; raise after all have ended if any
    failed."""
    global build_log
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        build_log += out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def check(err: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {err}")


def check_nans(name: str, *outs):
    """Raise ``FloatingPointError`` when an output of kernel ``name`` holds
    a NaN (one counted host read); the wrappers call it while
    ``NAN_CHECK`` is on."""
    if host.item(torch.stack([torch.isnan(t).any() for t in outs]).any()):
        raise FloatingPointError(
            f"invalid value (nan) encountered in CUDA kernel {name}")


def ptr(t) -> int | None:
    """Device pointer of a tensor (``None`` → NULL)."""
    return None if t is None else t.data_ptr()


def stream(device=None) -> int:
    """The current CUDA stream (of ``device``, a ``torch.device`` with an
    index, through PyTorch's raw-stream query: the launch wrappers run
    hundreds of times a solve)."""
    if device is not None:
        return torch._C._cuda_getCurrentRawStream(device.index)
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=None)
def _props(index: int):
    return torch.cuda.get_device_properties(index)


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device`` (the launch planners' input)."""
    return _props(device.index).multi_processor_count


def smem_optin(device) -> int:
    """Bytes of shared memory one CTA of ``device`` may opt in to."""
    return _props(device.index).shared_memory_per_block_optin


MAX_CLUSTER = 16   # CTAs of the largest (non-portable) cluster, common.cuh


def active_clusters(entry: str, index: int, *shape) -> int:
    """Clusters of a kernel's shape that device ``index`` holds at once:
    the C entry ``entry`` (a ``*_clusters`` function, which queries
    ``cudaOccupancyMaxActiveClusters`` once per shape and keeps the
    answer) called with ``shape``, the cluster's CTAs last."""
    count = ctypes.c_int(0)
    with torch.cuda.device(index):
        check(getattr(library(), entry)(*shape, ctypes.byref(count)), entry)
    return count.value


@functools.lru_cache(maxsize=None)
def largest_cluster(entry: str, index: int, *shape) -> int:
    """The most CTAs, at most ``MAX_CLUSTER``, of a cluster of which
    device ``index`` holds one (:func:`active_clusters` at ``shape``): the
    launch planners' input, as :func:`sm_count` is.  1 when it holds no
    cluster of 2."""
    for cluster in range(MAX_CLUSTER, 1, -1):
        if active_clusters(entry, index, *shape, cluster) >= 1:
            return cluster
    return 1


@functools.lru_cache(maxsize=16)
def momentum_table(coefs: tuple, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """The FISTA momentum coefficients ``coefs``
    (``ops/prox.py::fista_momentum``) as a device tensor of ``dtype``, made
    once per (coefficients, dtype, device) and kept: K1, GP, the
    union-block round and the varying-coefficient round read it, and a
    launch copies nothing."""
    return torch.tensor(coefs, dtype=dtype, device=device)


def require(cond: bool, msg: str, *args):
    """Wrapper-side input check (the kernels take no other shapes).  With
    ``args``, ``msg`` is a ``str.format`` template, filled only on failure
    (the checks run on every launch)."""
    if not cond:
        raise ValueError(msg.format(*args) if args else msg)
