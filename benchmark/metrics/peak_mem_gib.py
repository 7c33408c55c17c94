"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` from the run's start
to the window's close, on the fullest card, in GiB."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.peak_bytes / 2**30
