"""The repo's demos (``examples/``) on the port, each runnable as

    python -m coordinatedescent_jl_tpu_torch.examples.<name> [--cpu] [--small]

``atoms_demo`` (group atoms, symmetric iterates), ``lasso_path_demo`` (a λ
path with diagnostics), ``multichip_demo`` (the multi-device tiers on a
spawned world) and ``production_recipes`` (run accounting, the 1e-7
certificate, checkpoint and resume).  They call only the port's public
names and run on the card; ``--cpu`` runs the plain PyTorch path on the
CPU instead, ``--small`` cuts the shapes.
"""

import argparse


def parse(doc: str, argv=None):
    """The demos' two flags: ``--cpu`` and ``--small``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU; raises without "
                         "one)")
    ap.add_argument("--small", action="store_true", help="small shapes")
    args = ap.parse_args(argv)
    args.device = "cpu" if args.cpu else None
    return args
