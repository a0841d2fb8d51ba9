"""The benchmark of ``coordinatedescent_jl_tpu_torch`` on an NVIDIA H100.

``python3 -m cdbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (see ``run.py``); ``BENCHMARK.json``
at the root of the checkout names the cells, configurations and metrics,
and each of those sits in a file of its own here, found by name.  Nothing
here imports JAX or the JAX package.
"""
