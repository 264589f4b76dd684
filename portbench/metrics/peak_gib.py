"""``torch.cuda.max_memory_allocated()`` over the window (reset at its
start), in GiB."""


def read(run):
    return run.peak_bytes / float(1 << 30) if run.peak_bytes > 0 else None
