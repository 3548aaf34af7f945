"""The kernels layer: device milliseconds of the port's hand-written
kernels (``fslr_tpu_torch/csrc/*.cu``, launched through ``kernels.py``)
per 1,000 input reads, from the benchmark's own ``torch.profiler`` trace
of the window, the events matched by kernel name."""

UNIT = 'ms/kread'
KERNELS = ('mask_kernel', 'sw_dp', 'order_rows', 'banded_dp', 'prof_dp',
           'walk_kernel')


def read(rec):
    if rec.trace is None or not rec.reads:
        return None
    us = sum(v for k, v in rec.trace['by_kernel_us'].items()
             if k in KERNELS)
    if us <= 0:
        return None
    return us / 1e3 / (rec.reads / 1e3)
