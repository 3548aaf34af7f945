"""Device busy share of one pipeline run, per stage, under torch.profiler.

    python -m fslr_tpu_torch.tools.profile_run ROOT N_READS N_GROUPS \
        [--ref-bp BP] [--consensus] [--device cuda]

Writes the synthetic dataset (tools/synth.py) under ROOT, runs the CLI
once to build the kernels and the index cache, then once more under
``torch.profiler`` with CPU and CUDA activities.  Prints one JSON line:
the run's wall time, the union of the device-event intervals over it
(busy and idle share), the same per pipeline stage (the stages are named
ranges, see pipeline.py), and the ten largest device consumers by name.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from fslr_tpu_torch import cli
from fslr_tpu_torch.tools.synth import make_dataset


def _union_us(intervals) -> float:
    total, end = 0.0, float('-inf')
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _overlap_us(intervals, lo, hi) -> float:
    return _union_us((max(a, lo), min(b, hi)) for a, b in intervals
                     if b > lo and a < hi)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('root')
    ap.add_argument('n_reads', type=int)
    ap.add_argument('n_groups', type=int)
    ap.add_argument('--ref-bp', type=int, default=None)
    ap.add_argument('--consensus', action='store_true')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('profile_run needs a CUDA card')
    os.makedirs(args.root, exist_ok=True)
    ref, fq = make_dataset(args.root, args.n_reads, args.n_groups,
                           ref_mb=args.ref_bp)
    extra = ['--consensus'] if args.consensus else []

    def run(tag):
        cli.main(['--name', 'P', '--out', os.path.join(args.root, tag),
                  '--ref', ref, '--primers', '21q1,17p6', '--basecalled',
                  fq, '--device', args.device, *extra])

    run('warm')
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run('profiled')
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with open(os.path.join(args.root, 'profiled', 'P.timings.json')) as fh:
        names = set(json.load(fh)['timings_s'])
    events = list(prof.events())
    # device events: kernels, copies and sets; the stage ranges also show
    # on the device timeline as annotations and are left out
    dev = [(e.time_range.start, e.time_range.end) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name not in names]
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    span = (min(e.time_range.start for e in host),
            max(e.time_range.end for e in host))
    busy = _overlap_us(dev, *span)
    stages: dict = {}
    for e in host:
        if e.name in names:
            st = stages.setdefault(e.name, [0.0, 0.0])
            st[0] += e.time_range.end - e.time_range.start
            st[1] += _overlap_us(dev, e.time_range.start, e.time_range.end)
    top = sorted(((k.key, k.device_time_total) for k in prof.key_averages()
                  if k.device_time_total > 0 and k.key not in names),
                 key=lambda x: -x[1])[:10]
    print(json.dumps({
        'device': torch.cuda.get_device_name(0),
        'reads': args.n_reads, 'groups': args.n_groups,
        'consensus': args.consensus, 'wall_s': wall,
        'profiled_span_ms': (span[1] - span[0]) / 1e3,
        'device_busy_ms': busy / 1e3,
        'device_busy_share': busy / (span[1] - span[0]),
        'device_events': len(dev),
        'stages': {k: {'wall_ms': v[0] / 1e3, 'device_busy_ms': v[1] / 1e3,
                       'busy_share': v[1] / v[0] if v[0] else 0.0}
                   for k, v in sorted(stages.items(),
                                      key=lambda kv: -kv[1][0])},
        'top_device_ms': {k: v / 1e3 for k, v in top}}))


if __name__ == '__main__':
    main()
