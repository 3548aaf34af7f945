"""The repeat mask kernel's share of its roofline: the least time the
card could take for the window's masking (the larger of its operations
over the card's float32 peak and its bytes over its memory bandwidth,
``benchmark/work/mask_kernel.py`` and ``benchmark/peaks.json``) over the
device time of its events in the trace, in percent.  Nothing to read on
a card without an entry in the table of peaks or without a mask event."""

import json
import os

UNIT = '%'
KERNEL = 'mask_kernel'


def read(rec):
    if rec.trace is None:
        return None
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), 'peaks.json')) as fh:
        peak = json.load(fh).get(rec.device['kind'])
    us = rec.trace['by_kernel_us'].get(KERNEL, 0.0)
    if peak is None or us <= 0:
        return None
    w = rec.work(KERNEL)
    least = max(w['ops'] / peak['f32_flop_per_s'],
                w['bytes'] / peak['hbm_bytes_per_s'])
    return 100.0 * least / (us / 1e6)
