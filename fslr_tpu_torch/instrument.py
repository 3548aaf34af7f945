"""Per-stage timing + optional profiler traces.

The reference's observability is stderr prints (SURVEY.md section 5.1);
here every pipeline stage is timed first-class: ``StageTimer`` collects
wall-clock per stage, prints a summary, and writes
``{basename}.timings.json``.  Copied from ``fslr_tpu/instrument.py``;
its profiler hook runs torch.profiler where fslr_tpu's runs
jax.profiler: with ``FSLR_PROFILE_DIR`` set, a run is traced from
``start_profile`` to ``stop_profile`` (CPU activity, and the card's on a
CUDA device), the Chrome trace goes to that folder and the trace's
reading (tools/profile_run.read_profile: device busy share, per stage
too, and the largest device consumers) to ``timings.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time


# ---------------------------------------------------------------------------
# DP-cell accounting (BASELINE.md target table: "Alignment DP cell-updates/s
# measured & reported alongside reads/s").  Stage code calls add_cells() with
# the number of useful dynamic-programming cell updates it dispatched (SW
# primer scans, banded extension, traceback); bench.py divides by stage wall
# time.  A module counter under a lock: with --procs, input files are
# filtered on several host threads.

_dp_cells: dict = {}
_cells_lock = threading.Lock()


def add_cells(n: int, tag: str = 'dp') -> None:
    with _cells_lock:
        _dp_cells[tag] = _dp_cells.get(tag, 0) + int(n)


def cell_count(tag: str | None = None) -> int:
    if tag is not None:
        return _dp_cells.get(tag, 0)
    return sum(_dp_cells.values())


def cell_counts() -> dict:
    return dict(_dp_cells)


def reset_cells() -> None:
    _dp_cells.clear()


class StageTimer:
    """Wall seconds and calls of each stage.  On a CUDA ``device`` it also
    reads the peak device memory (``max_memory_allocated``, a host-side
    counter: no synchronisation) at each stage's end, and credits each
    rise of it to the stage at whose end it showed (``peak_rise``).
    ``notes`` holds what a stage reports of itself (clustering: its
    query_graph's path and sizes); report() writes both out."""

    def __init__(self, device=None):
        self.timings: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.notes: dict = {}
        self.profile: dict | None = None
        self._prof = None
        self._cuda = device is not None and device.type == 'cuda'
        self.device = device
        self.peak_rise: dict[str, int] = {}
        self._peak = self._max_allocated()

    def _max_allocated(self) -> int:
        if not self._cuda:
            return 0
        import torch
        return torch.cuda.max_memory_allocated(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            peak = self._max_allocated()
            if peak > self._peak:
                self.peak_rise[name] = (self.peak_rise.get(name, 0)
                                        + peak - self._peak)
                self._peak = peak

    def start_profile(self, device):
        """With FSLR_PROFILE_DIR set, start torch.profiler over CPU
        activity and, on a CUDA ``device``, the card's; raises if the
        card cannot be traced.  Unset, nothing happens."""
        if not os.environ.get('FSLR_PROFILE_DIR'):
            return
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == 'cuda':
            if torch.profiler.ProfilerActivity.CUDA not in \
                    torch.profiler.supported_activities():
                raise RuntimeError('FSLR_PROFILE_DIR is set, but '
                                   'torch.profiler cannot trace the card')
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop_profile(self, name: str, device, failed: bool = False):
        """Stop the profiler (once the device's queue has drained), write
        ``{FSLR_PROFILE_DIR}/{name}.pt.trace.json`` and keep its reading
        in ``self.profile``, which report() writes out.  A no-op when no
        profile runs.  With ``failed`` (the run raised) it only stops the
        profiler, writes nothing and raises nothing, so that the run's
        own error is the one that shows."""
        if self._prof is None:
            return
        import torch

        from fslr_tpu_torch.tools.profile_run import read_profile
        prof, self._prof = self._prof, None
        if failed:
            with contextlib.suppress(Exception):
                prof.stop()
            print('profiler stopped: the run failed, no trace written',
                  file=sys.stderr)
            return
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - self._t0
        prof.stop()
        trace_dir = os.environ['FSLR_PROFILE_DIR']
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f'{name}.pt.trace.json')
        prof.export_chrome_trace(path)
        self.profile = {'trace': path, 'wall_s': wall,
                        **read_profile(prof, set(self.timings))}
        print(f'profiler trace written to {path}', file=sys.stderr)

    def report(self, path: str | None = None):
        total = sum(self.timings.values())
        lines = ['stage timings:']
        for name, dt in sorted(self.timings.items(), key=lambda x: -x[1]):
            pct = 100.0 * dt / total if total else 0.0
            lines.append(f'  {name:<24s} {dt:8.2f}s  {pct:5.1f}%  '
                         f'(x{self.counts[name]})')
        print('\n'.join(lines), file=sys.stderr)
        if path:
            extra = {'profile': self.profile} if self.profile else {}
            if self._cuda:
                extra['device_peak_bytes'] = self._peak
                extra['device_peak_rise_bytes'] = self.peak_rise
            with open(path, 'w') as fh:
                json.dump({'timings_s': self.timings,
                           'counts': self.counts, **self.notes, **extra},
                          fh, indent=1)
