"""Device busy share of one pipeline run, per stage, under torch.profiler.

    python -m fslr_tpu_torch.tools.profile_run ROOT N_READS N_GROUPS \
        [--ref-bp BP] [--consensus] [--device cuda]

Writes the synthetic dataset (tools/synth.py) under ROOT, runs the CLI
once to build the kernels and the index cache, then once more with
``FSLR_PROFILE_DIR`` set (ROOT/trace), so that the pipeline's own hook
(instrument.StageTimer) traces it with CPU and CUDA activities.  Prints
one JSON line: the hook's reading of the trace (:func:`read_profile`):
the run's wall time, the union of the device-event intervals over it
(busy and idle share), the same per pipeline stage (the stages are named
ranges, see pipeline.py), and the ten largest device consumers by name.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os

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


def _events(prof):
    """(name, start us, end us, on the card) of each event of a stopped
    profiler: its raw events (``profiler.kineto_results``, not a public
    API; read on torch 2.x), or the public ``events()`` where a torch
    lacks them."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof, 'profiler', None), 'kineto_results', None)
    if raw is None:
        for e in prof.events():
            yield (e.name, e.time_range.start, e.time_range.end,
                   e.device_type == cuda)
        return
    for e in raw.events():
        a = e.start_ns() / 1e3
        yield e.name(), a, a + e.duration_ns() / 1e3, e.device_type() == cuda


def read_profile(prof, names) -> dict:
    """The reading of a stopped ``torch.profiler.profile`` of a run whose
    stages are the named ranges ``names``: the profiled span, the device
    busy time and share over it (the union of the device events'
    intervals), the same per stage, and the ten largest device consumers
    by event name (ms).  It walks the profiler's raw events, without
    building ``prof.events()``' tree (25x slower at 10^5-10^6 events),
    where the profiler has them (:func:`_events`)."""
    dev, host, stages, by_name = [], [float('inf'), float('-inf')], {}, {}
    for name, a, b, on_device in _events(prof):
        if on_device:
            # kernels, copies and sets; the stage ranges also show on
            # the device timeline as annotations and are left out
            if name not in names:
                dev.append((a, b))
                by_name[name] = by_name.get(name, 0.0) + (b - a)
            continue
        host[0], host[1] = min(host[0], a), max(host[1], b)
        if name in names:
            stages.setdefault(name, []).append((a, b))
    span = host if host[1] > host[0] else (0.0, 0.0)
    busy = _overlap_us(dev, *span)
    wall = span[1] - span[0]
    per = {k: (sum(b - a for a, b in v),
               sum(_overlap_us(dev, a, b) for a, b in v))
           for k, v in stages.items()}
    top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    return {
        'profiled_span_ms': wall / 1e3,
        'device_busy_ms': busy / 1e3,
        'device_busy_share': busy / wall if wall > 0 else 0.0,
        'device_events': len(dev),
        'stages': {k: {'wall_ms': w / 1e3, 'device_busy_ms': d / 1e3,
                       'busy_share': d / w if w else 0.0}
                   for k, (w, d) in sorted(per.items(),
                                           key=lambda kv: -kv[1][0])},
        'top_device_ms': {k: v / 1e3 for k, v in top}}


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
    prev = os.environ.get('FSLR_PROFILE_DIR')
    os.environ['FSLR_PROFILE_DIR'] = os.path.join(args.root, 'trace')
    try:
        run('profiled')
    finally:
        if prev is None:
            del os.environ['FSLR_PROFILE_DIR']
        else:
            os.environ['FSLR_PROFILE_DIR'] = prev
    with open(os.path.join(args.root, 'profiled', 'P.timings.json')) as fh:
        profile = json.load(fh)['profile']
    print(json.dumps({
        'device': torch.cuda.get_device_name(0),
        'reads': args.n_reads, 'groups': args.n_groups,
        'consensus': args.consensus, **profile}))


if __name__ == '__main__':
    main()
