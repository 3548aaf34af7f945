"""Reduction of the window's ``torch.profiler`` trace.

The interval union (:func:`union_us`) and the walk over the profiler's
raw events (:func:`events`) are copies of
``fslr_tpu_torch/tools/profile_run.py``'s ``_union_us`` and
``_events``.  :func:`reduce` turns a stopped
profiler into what the per-layer metrics and the result's ``device`` and
``breakdown`` read: the device's busy time (the union of the intervals
of its events in the window), the time by kernel name, and the
device's idle time by the pipeline stage (a ``record_function`` range of
``fslr_tpu_torch/pipeline.py``) the host was in.
"""

from __future__ import annotations

import torch


def union_us(intervals) -> float:
    total, end = 0.0, float('-inf')
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def merged(intervals) -> list:
    """The union of ``intervals`` as disjoint sorted intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def events(prof):
    """(name, start us, end us, on the card) of each event of a stopped
    profiler: its raw events (``profiler.kineto_results``), or the public
    ``events()`` where a torch lacks them."""
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


def kernel_name(name: str) -> str:
    """A device event's name without its return type, template arguments
    and parameter list: ``void sw_dp<true>(...)`` -> ``sw_dp``; a copy or
    a set keeps its kind: ``Memcpy HtoD``."""
    if name.startswith(('Memcpy', 'Memset')):
        return ' '.join(name.split()[:2])
    name = name.replace('(anonymous namespace)::', '')
    base = name.split('(', 1)[0].split('<', 1)[0].split()
    return base[-1] if base else name


def reduce(prof, stage_names, window: str) -> dict:
    """The device's busy time over the window, the window's length, the
    device time by kernel name, and idle time by the stage the host was
    in (the innermost stage range over each part of an idle gap;
    ``between_stages`` where none is).  The window is the host range
    named ``window``, in the trace's own clock."""
    lo = hi = None
    raw, stages = [], []
    for name, a, b, on_device in events(prof):
        if on_device:
            # the stage ranges also show on the device timeline as
            # annotations; they are left out
            if name not in stage_names and name != window:
                raw.append((name, a, b))
        elif name == window:
            lo, hi = a, b
        elif name in stage_names:
            stages.append((name, a, b))
    if lo is None:
        raise RuntimeError(f'the trace holds no range {window!r}')
    dev = [(n, max(a, lo), min(b, hi)) for n, a, b in raw
           if b > lo and a < hi]
    busy = union_us((a, b) for _, a, b in dev)
    by_name: dict = {}
    for name, a, b in dev:
        k = kernel_name(name)
        by_name[k] = by_name.get(k, 0.0) + (b - a)
    idle: dict = {}
    spans = merged((a, b) for _, a, b in dev)
    edges = [lo] + [x for ab in spans for x in ab] + [hi]
    cuts = sorted({x for _, s, e in stages for x in (s, e)})
    for a, b in zip(edges[::2], edges[1::2]):
        # an idle gap, cut where a stage range starts or ends inside it
        pts = [a] + [x for x in cuts if a < x < b] + [b]
        for u, v in zip(pts, pts[1:]):
            mid = (u + v) / 2
            inside = [(e - s, n) for n, s, e in stages if s <= mid <= e]
            k = min(inside)[1] if inside else 'between_stages'
            idle[k] = idle.get(k, 0.0) + (v - u)
    return {'busy_us': busy, 'window_us': hi - lo,
            'by_kernel_us': by_name, 'idle_by_stage_us': idle}
