"""Device memory the job needs: ``torch.cuda.max_memory_allocated`` over
the window (reset at its start), in GiB."""


def read(rec):
    if rec.peak_mem_bytes is None:
        return None
    return rec.peak_mem_bytes / 2 ** 30
