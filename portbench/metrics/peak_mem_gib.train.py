"""torch.cuda.max_memory_allocated over the window (the peak statistics
reset as it starts), in GiB."""


def read(run):
    if not run.work.get("train_step") or not run.counts.get("peak_mem_bytes"):
        return None
    return run.counts["peak_mem_bytes"] / 2**30
