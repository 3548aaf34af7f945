"""The device's peak memory over the window:
``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``
at the window's start, in GiB."""

UNIT = 'GiB'


def read(rec):
    if not rec.peak_bytes:
        return None
    return rec.peak_bytes / 2**30
