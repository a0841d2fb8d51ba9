"""The plain references that decide ``correct``.

``solvers.py`` and ``vc_solver.py`` solve the problems from their
objectives in plain PyTorch; a module per task (the name a traffic mix's
``task`` gives) has ``judge(state, kept)``, which works out every problem
of ``kept`` (``{window index: (pool index, the program's output)}``)
again from the inputs the harness made and returns the numbers compared,
``{window index: {name: value}}``, and ``control(state, i, k, spec)``,
the reference itself in the program's place, each part of the output
computed in the lower precision that ``spec`` (the traffic mix's
``control``: ``{number compared: precision}``) names for the number that
judges it.  Nothing here imports the port or the JAX package.
"""

from __future__ import annotations

import contextlib

import torch

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


@contextlib.contextmanager
def precision(spec: dict):
    """``spec``: ``{"dtype": ..., "tf32": bool}``; yields the dtype, with
    TF32 matmuls on or off as asked, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(spec.get("tf32", False))
    try:
        yield _DTYPES[spec["dtype"]]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def rel_err(out, ref) -> float:
    """``max |out − ref| / max |ref|`` in float64; infinite where the
    shapes differ or ``out`` is not finite."""
    out = torch.as_tensor(out).to(device=ref.device, dtype=torch.float64)
    if out.shape != ref.shape or not bool(torch.all(torch.isfinite(out))):
        return float("inf")
    scale = float(torch.amax(torch.abs(ref)))
    return float(torch.amax(torch.abs(out - ref))) / max(scale, 1e-300)


REFERENCE = {"dtype": "float64", "tf32": False}
