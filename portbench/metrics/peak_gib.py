"""Peak device memory over the whole run, set-up included (GiB):
``torch.cuda.max_memory_allocated()``."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
