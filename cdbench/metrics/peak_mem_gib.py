"""``torch.cuda.max_memory_allocated()`` over set-up and window (the peak
statistics reset at the process's start), in GiB."""


def read(rec):
    return rec["memory_peak_bytes"] / 2**30
