"""torch.cuda.max_memory_allocated() from process start to the window's end,
read before the check, in GiB."""


def read(run):
    return run.peak_mem_bytes / 2 ** 30 if run.peak_mem_bytes else None
