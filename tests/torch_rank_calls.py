"""The rank program of the multi-device parity tests: a list of calls of
the port's entry points, made in every rank of a world of spawned ranks
(``coordinatedescent_jl_tpu_torch.parallel.distributed.World``), each
result brought back as numpy.  A spawned rank imports this module, torch
and the port, never JAX."""

from __future__ import annotations

import importlib
import inspect
from typing import NamedTuple

import torch

from coordinatedescent_jl_tpu_torch.parallel.distributed import make_mesh

PKG = "coordinatedescent_jl_tpu_torch"


def to_host(obj):
    """``obj`` with every tensor as a numpy array, every named tuple as a
    dict (with its type's name under ``"_type"``) and a ``DeviceMesh`` as
    its axis names and shape: a result that pickles without torch's storage
    sharing."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, DeviceMesh):
        return {"_type": "DeviceMesh", "names": tuple(obj.mesh_dim_names),
                "shape": tuple(obj.mesh.shape)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        out = {f: to_host(getattr(obj, f)) for f in obj._fields}
        out["_type"] = type(obj).__name__
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


class Call(NamedTuple):
    """A call made in the rank, whose result is an argument of another
    call of :func:`run_calls` (``target``, ``args``, ``kwargs`` as there)."""

    target: str
    args: tuple = ()
    kwargs: dict = {}


def run_calls(calls, device):
    """Make each call of ``calls`` and yield its result through
    :func:`to_host` (a :class:`World` streams each as a part of the rank's
    result).  A call is ``(target, mesh, args, kwargs)``: ``target`` a
    function's dotted path inside the port (``"parallel.lasso_sharded"``),
    ``mesh`` ``None`` or ``(shape, names)``, given to the call (and to the
    :class:`Call` arguments in it) as its ``mesh`` keyword, and ``device``
    as its ``device`` keyword (where the function takes them); a call with
    a ``stats`` keyword gets a fresh dict there and gives ``(result,
    stats)``.  A call that raises gives ``{"_error": "<type>: <message>"}``
    (the ranks must raise alike: a collective that some ranks skip ends
    the world at its timeout)."""
    meshes = {}

    def invoke(target, mesh, args, kwargs):
        mod, name = target.rsplit(".", 1)
        fn = getattr(importlib.import_module(f"{PKG}.{mod}"), name)
        params = inspect.signature(fn).parameters
        kw = {k: resolve(v, mesh) for k, v in kwargs.items()}
        if mesh is not None and "mesh" in params:
            key = (tuple(mesh[0]), tuple(mesh[1]))
            if key not in meshes:
                meshes[key] = make_mesh(*key)
            kw["mesh"] = meshes[key]
        if "device" in params and "device" not in kw:
            kw["device"] = device
        args = [resolve(a, mesh) for a in args]
        if "stats" in kw:                      # an out-parameter: return it
            kw["stats"] = {}
            return fn(*args, **kw), kw["stats"]
        return fn(*args, **kw)

    def resolve(obj, mesh):
        if isinstance(obj, Call):
            return invoke(obj.target, mesh, obj.args, obj.kwargs)
        return obj

    for target, mesh, args, kwargs in calls:
        try:
            yield to_host(invoke(target, mesh, args, kwargs))
        except Exception as e:                  # noqa: BLE001 (reported)
            yield {"_error": f"{type(e).__name__}: {e}"}
