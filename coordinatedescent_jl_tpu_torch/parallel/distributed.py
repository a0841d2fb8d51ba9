"""Process groups, meshes and sharded data ingestion on ``torch.distributed``
(counterpart of ``coordinatedescent_jl_tpu/parallel/distributed.py``).

The JAX package runs one controller over a ``Mesh`` of devices; here every
device is a rank of its own process (SPMD), and every rank calls an entry
point with the same arguments:

- ``initialize_distributed``: ``torch.distributed.init_process_group``,
  NCCL on CUDA and Gloo on the CPU, with a finite timeout, so a rank that
  diverges fails instead of hanging.  ``torchrun --nproc-per-node N``
  sets what it reads (``env://``); a coordinator address or a ``store``
  can be given instead.
- ``feature_mesh`` / ``grid_mesh`` / ``obs_mesh`` / ``make_mesh``: a
  ``DeviceMesh`` over the world with the JAX package's axis names
  (``"feature"``, ``"batch"``, ``"obs"``); ranks fill the mesh in
  row-major order, as the JAX constructors reshape their device list.
- ``plan_column_shards``, ``plan_device_columns``, ``load_design_shard``:
  the pure arithmetic and the memory-mapped read of the JAX module, copied.
- ``shard_design_matrix``: this rank's column block and its global offset
  as a :class:`ShardedDesign`, which the feature-sharded entry points take
  in place of the global design; the design is never replicated.
- ``World`` / ``launch``: start a world of ``n`` spawned processes on
  this machine (Gloo on the CPU, or Gloo on one card), run a function in
  every rank and return each rank's result (the dry run and
  ``chip_smoke.py``'s two-rank world start theirs so).
- ``rank_device``: the entry points' device rule: ``device=None`` means
  ``cuda:<LOCAL_RANK>`` (``cuda:0`` when ``LOCAL_RANK`` is unset), and
  raises without a GPU; ``device="cpu"`` runs the plain path.
"""

from __future__ import annotations

import datetime
import inspect
import os
import queue
import socket
import threading
import time
import traceback
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.helpers import on_device, target_device
from ._collectives import axis_rank, axis_size


def rank_device(device=None) -> torch.device:
    """The device of this rank's shard: ``None`` means
    ``cuda:<LOCAL_RANK>`` (``LOCAL_RANK`` unset: ``cuda:0``); raises a
    ``RuntimeError`` when CUDA is asked for and there is no GPU."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return target_device(device)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           timeout: float = 600.0, store=None) -> None:
    """Bring up the default process group once per process.

    ``backend`` ``None``: NCCL when a GPU is present, else Gloo.  With a
    ``store`` (for example a ``HashStore`` for a world of one) the world
    size and rank are ``num_processes`` / ``process_id`` (default 1 / 0);
    with ``coordinator_address`` (``"host:port"``) the group meets there;
    with neither, ``env://`` (what ``torchrun`` sets).  ``timeout``
    seconds bound every collective, so a diverged rank raises."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout))
    if store is not None:
        kw.update(store=store, world_size=num_processes or 1,
                  rank=process_id or 0)
    else:
        kw["init_method"] = ("env://" if coordinator_address is None
                             else f"tcp://{coordinator_address}")
        if num_processes is not None:
            kw.update(world_size=num_processes, rank=process_id)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(**kw)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape, names):
    """A ``DeviceMesh`` of the given shape and axis names over the world."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != dist.get_world_size():
        raise ValueError(f"mesh shape {shape} does not cover the "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(_device_type(), shape,
                            mesh_dim_names=tuple(names))


def feature_mesh():
    """1-D ``("feature",)`` mesh over every rank."""
    return make_mesh((dist.get_world_size(),), ("feature",))


def grid_mesh(batch: int):
    """2-D ``("batch", "feature")`` mesh: scenario batches on the outer
    axis, feature shards on the inner one (ranks ``b·F … b·F + F − 1``
    form batch row ``b``)."""
    world = dist.get_world_size()
    if world % batch:
        raise ValueError(f"{world} devices not divisible by batch={batch}")
    return make_mesh((batch, world // batch), ("batch", "feature"))


def obs_mesh():
    """1-D ``("obs",)`` mesh over every rank (the row-sharded tier)."""
    return make_mesh((dist.get_world_size(),), ("obs",))


def plan_column_shards(p: int, num_shards: int) -> list:
    """Per-shard global column ranges ``[(lo, hi), …]`` for an even
    ceil-division split of ``p`` columns over ``num_shards`` ranks:
    disjoint, ordered, covering ``[0, p)``; trailing shards may be ragged
    (possibly empty)."""
    cols = -(-p // num_shards)
    return [(min(s * cols, p), min((s + 1) * cols, p))
            for s in range(num_shards)]


def plan_device_columns(p_local: int, n_local_devices: int) -> list:
    """Per-local-device slices of a process's ``p_local`` columns:
    ``[(lo, hi, pad), …]`` with ``hi − lo + pad`` equal for every device
    (ragged tails are zero-padded)."""
    per_dev = -(-p_local // n_local_devices)
    out = []
    for i in range(n_local_devices):
        lo = min(i * per_dev, p_local)
        hi = min(lo + per_dev, p_local)
        out.append((lo, hi, per_dev - (hi - lo)))
    return out


def load_design_shard(path: str, n: int, p: int, shard_index: int,
                      num_shards: int, dtype=np.float32) -> np.ndarray:
    """Memory-map the column block ``shard_index`` of an (n, p) row-major
    binary design matrix on disk (plain C-order ``dtype[n, p]``), copying
    only this rank's columns."""
    lo, hi = plan_column_shards(p, num_shards)[shard_index]
    mm = np.memmap(path, dtype=dtype, mode="r", shape=(n, p))
    return np.ascontiguousarray(mm[:, lo:hi])


class ShardedDesign(NamedTuple):
    """This rank's column block ``local (n, hi − lo)`` of an ``(n, p)``
    design and its first global column ``offset``."""

    local: torch.Tensor
    offset: int
    n: int
    p: int


def _check_layout(p: int, D: int, s: int, width: int) -> int:
    """The plan's checks of ``shard_design_matrix``; returns the offset."""
    plan = plan_column_shards(p, D)
    widths = [hi - lo for lo, hi in plan]
    # zero columns may only stand at the global tail: an interior gap would
    # shift every later column off its feature index
    if any(w != widths[0] for w in widths[:-1]):
        raise ValueError(
            f"p={p} over {D} ranks would need interior zero columns; pad p "
            f"to a multiple of {D} first (ragged width is allowed only on "
            f"the final rank)")
    if width != widths[s]:
        raise ValueError(
            f"x_local has {width} columns but rank {s} owns {widths[s]} "
            f"per plan_column_shards({p}, {D})")
    return plan[s][0]


def shard_design_matrix(mesh, x_local, n: int, p: int, *,
                        axis: str = "feature", device=None) -> ShardedDesign:
    """This rank's block of the global column-sharded ``(n, p)`` design,
    without replication: ``x_local`` is the rank's ``(n, p_local)`` block of
    ``plan_column_shards(p, D)`` (e.g. from ``load_design_shard``), moved
    to ``device`` (``None``: ``cuda:<LOCAL_RANK>``).  The feature-sharded
    entry points take the result in place of ``X``."""
    D, s = axis_size(mesh, axis), axis_rank(mesh, axis)
    x_local = on_device(x_local, rank_device(device))
    if tuple(x_local.shape[:1]) != (n,):
        raise ValueError(f"x_local has {x_local.shape[0]} rows, expected {n}")
    off = _check_layout(p, D, s, x_local.shape[1])
    return ShardedDesign(x_local, off, n, p)


def load_sharded_design(path: str, n: int, p: int, mesh, *,
                        axis: str = "feature", dtype=np.float32,
                        device=None) -> ShardedDesign:
    """This rank's block of an (n, p) design on disk: ``load_design_shard``
    at the rank's index on ``mesh[axis]``, then ``shard_design_matrix``."""
    x = load_design_shard(path, n, p, axis_rank(mesh, axis),
                          axis_size(mesh, axis), dtype)
    return shard_design_matrix(mesh, x, n, p, axis=axis, device=device)


def column_exchange(spans, ranges) -> list:
    """The pieces of the ranks' blocks that another rank's range needs:
    ``[(src, dst, lo, hi), …]`` (global columns ``[lo, hi)`` of rank
    ``src``'s block, for rank ``dst``), for blocks ``spans[q] = (offset,
    width)`` and ranges ``ranges[d] = (lo, hi)``.  For the plan's blocks
    and the solver's ranges (``_shard_chunk``) a rank receives only the
    columns by which the two layouts are offset, fewer than ``B·D``."""
    out = []
    for d, (lo, hi) in enumerate(ranges):
        for q, (o, w) in enumerate(spans):
            a, b = max(o, lo), min(o + w, hi)
            if q != d and a < b:
                out.append((q, d, a, b))
    return out


def local_columns(X, group, s: int, lo: int, hi: int, width: int, dev,
                  dtype=None):
    """Columns ``[lo, hi)`` of the global design ``X`` (numpy, tensor or a
    :class:`ShardedDesign`), zero-padded on the right to ``width``, on
    ``dev``.  From a global design only these columns are copied; a
    :class:`ShardedDesign` whose block is another range takes the columns
    it lacks from the ranks that hold them (:func:`column_exchange`, one
    batch of point-to-point sends and receives), never a whole block."""
    if isinstance(X, ShardedDesign):
        from ._collectives import all_gather

        dtype = dtype or X.local.dtype
        off, w = X.offset, X.local.shape[1]
        # every rank learns every block and every range (a collective on
        # both branches' behalf)
        meta = torch.tensor([off, w, lo, hi], dtype=torch.int64, device=dev)
        spans = all_gather(meta, group).tolist()
        plan = column_exchange([m[:2] for m in spans],
                               [m[2:] for m in spans])
        if (off, w) == (lo, hi - lo):
            out = X.local.to(device=dev, dtype=dtype)
        else:
            out = torch.zeros((X.n, hi - lo), dtype=dtype, device=dev)
            a, b = max(off, lo), min(off + w, hi)
            if a < b:
                out[:, a - lo:b - lo] = X.local[:, a - off:b - off].to(
                    device=dev, dtype=dtype)
        # a Gloo group takes host tensors (staged as in _collectives)
        host = (torch.device(dev).type == "cuda"
                and dist.get_backend(group) == "gloo")
        buf_dev = torch.device("cpu") if host else dev
        ops, recvs = [], []
        for q, d, a, b in plan:
            if q == s:
                piece = X.local[:, a - off:b - off].to(
                    device=buf_dev, dtype=dtype).contiguous()
                ops.append(dist.P2POp(dist.isend, piece,
                                      dist.get_global_rank(group, d), group))
            elif d == s:
                buf = torch.empty((X.n, b - a), dtype=dtype, device=buf_dev)
                ops.append(dist.P2POp(dist.irecv, buf,
                                      dist.get_global_rank(group, q), group))
                recvs.append((a, b, buf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for a, b, buf in recvs:
            out[:, a - lo:b - lo] = buf.to(dev)
    else:
        out = torch.as_tensor(X)[:, lo:hi].to(device=dev, dtype=dtype)
    if out.shape[1] < width:
        out = torch.nn.functional.pad(out, (0, width - out.shape[1]))
    return out.contiguous()


# ---------------------------------------------------------------------------
# A world of spawned ranks on this machine
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _rank_main(fn, rank, world, port, backend, timeout, args, q):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        res = fn(*args)
        if inspect.isgenerator(res):        # stream each part as it comes
            parts = []
            for v in res:
                q.put((rank, "part", (len(parts), v)))
                parts.append(v)
            res = parts
        q.put((rank, "done", res))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))   # for the parent
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """A world of ``n_ranks`` spawned processes on this machine running
    ``fn(*args)`` after ``init_process_group`` (``tcp://127.0.0.1:<free
    port>``, the collectives' timeout ``timeout`` seconds).  It starts at
    construction.  Where ``fn`` is a generator function, a rank's result
    is the list of what it yields, and :meth:`part` gives item ``i`` as
    soon as every rank has yielded it; :meth:`wait` gives the results.
    ``fn`` and its arguments must be picklable (a module-level function of
    this package).  Both raise ``RuntimeError`` when a rank raises (with
    its traceback) or exits without a result, or when the world has not
    finished ``timeout`` seconds after its start, and then stop every
    process; they raise the error of a process that could not start
    (``OSError`` where this machine cannot spawn)."""

    def __init__(self, fn, n_ranks: int, args=(), backend: str = "gloo",
                 timeout: float = 120.0):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n, self.timeout = n_ranks, timeout
        self.q = ctx.Queue()
        port = _free_port()
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(fn, r, n_ranks, port, backend,
                                        timeout, args, self.q), daemon=True)
                      for r in range(n_ranks)]
        self.parts = [{} for _ in range(n_ranks)]
        self.results = {}
        # a start returns once the child has read its arguments, after its
        # imports: start them from a thread, so the caller goes on at once
        self.start_error = None
        self.starter = threading.Thread(target=self._start, daemon=True)
        self.starter.start()
        self.deadline = time.monotonic() + timeout

    def _start(self):
        try:
            for pr in self.procs:
                pr.start()
        except Exception as e:                      # reported by _pump
            self.start_error = e

    def _pump(self, ready):
        """Read the ranks' messages until ``ready()``."""
        self.starter.join()
        if self.start_error is not None:          # e.g. OSError: no spawn
            raise self.start_error
        while not ready():
            left = self.deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"the world of {self.n} ranks did not "
                                   f"finish within {self.timeout:g} s")
            try:
                rank, kind, val = self.q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [(r, pr.exitcode) for r, pr in enumerate(self.procs)
                        if r not in self.results
                        and pr.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) exited without a result: "
                                       f"{dead}")
                continue
            if kind == "error":
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            if kind == "part":
                self.parts[rank][val[0]] = val[1]
            else:
                self.results[rank] = val

    def part(self, i) -> list:
        """Part ``i`` of every rank's result, in rank order."""
        try:
            self._pump(lambda: all(i in p for p in self.parts))
        except BaseException:
            self.close()
            raise
        return [p[i] for p in self.parts]

    def wait(self) -> list:
        """The ranks' results in rank order; the processes are stopped."""
        try:
            self._pump(lambda: len(self.results) == self.n)
        finally:
            self.close()
        return [self.results[r] for r in range(self.n)]

    def close(self):
        """Stop every process (those that finished are joined)."""
        done = len(self.results) == self.n
        for pr in self.procs:
            if pr.pid is None:                      # never started
                continue
            pr.join(timeout=5.0 if done else 0.1)
            if pr.is_alive():
                pr.terminate()
                pr.join(timeout=5.0)
            if pr.is_alive():
                pr.kill()
                pr.join()


def launch(fn, n_ranks: int, *args, backend: str = "gloo",
           timeout: float = 120.0) -> list:
    """Run ``fn(*args)`` in a :class:`World` of ``n_ranks`` spawned
    processes and return the ranks' results in rank order (raises as
    :meth:`World.wait`)."""
    return World(fn, n_ranks, args, backend, timeout).wait()
