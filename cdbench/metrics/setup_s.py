"""From the start of the harness's process to the first timed problem:
imports, the kernels' build where the checkout has none, the design and
the response pool, the penalties, the warm-up problem."""


def read(rec):
    return rec["setup_s"]
