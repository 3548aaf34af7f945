"""The device's idle share of the traced window: 1 - (the union of the
intervals of every device event in the window) / (the window's length),
in percent (``benchmark/trace.py``, the interval union copied from
``fslr_tpu_torch/tools/profile_run.py``)."""

UNIT = '%'


def read(rec):
    if rec.trace is None or rec.trace['window_us'] <= 0:
        return None
    return 100.0 * (1.0 - rec.trace['busy_us'] / rec.trace['window_us'])
