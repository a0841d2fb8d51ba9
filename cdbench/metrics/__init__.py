"""One reader a metric, named as the metric in ``BENCHMARK.json``:
``read(rec)`` takes the run's record (``run.run_cell``'s: the problems
with their host-clock spans and counts, the window, the counters, the
traced problems) and returns the number, or None where the record holds
nothing to read, and the metric is then left out of the line."""


def block_size(rec) -> int:
    """The block width the cell's solves run at: the traffic mix's
    ``options``, the port's default where they name none."""
    from coordinatedescent_jl_tpu_torch import CDOptions

    return CDOptions(**rec["traffic"].get("options", {})).block_size
