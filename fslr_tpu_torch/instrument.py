"""Per-stage timing + optional profiler traces.

The reference's observability is stderr prints (SURVEY.md section 5.1);
here every pipeline stage is timed first-class: ``StageTimer`` collects
the seconds of each stage and of the steps inside it (:func:`span`),
prints a summary, and writes ``{basename}.timings.json``.  On the
thread that made the timer each span is also a
``torch.profiler.record_function`` range of the name it records under,
so a trace and ``timings.json`` name the same spans.  From
``fslr_tpu/instrument.py``; its profiler hook runs torch.profiler where
fslr_tpu's runs jax.profiler: with ``FSLR_PROFILE_DIR`` set, a run is
traced from ``start_profile`` to ``stop_profile`` (CPU activity, and the
card's on a CUDA device), the Chrome trace goes to that folder and the
trace's reading (tools/profile_run.read_profile: device busy share, per
stage too, and the largest device consumers) to ``timings.json``.
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
    """Seconds (``time.perf_counter``) and calls of each span: a stage
    (:meth:`stage`, under its literal name) or a step inside one
    (:func:`span`, under ``<open span>.<step>``).  A span never waits for
    the device: device work queued inside it shows in whichever span
    later waits for it.  On the thread that made the timer a span is also
    a ``torch.profiler.record_function`` range of its name; spans on
    other host threads (the index thread's ``index_*``) record seconds
    only.  On a CUDA ``device`` it also reads the peak device memory
    (``max_memory_allocated``, a host-side counter: no synchronisation)
    at each span's end, and credits each rise of it to the span at whose
    end it showed, the innermost one (``peak_rise``).  ``notes`` holds
    what a stage reports of itself (clustering: its query_graph's path
    and sizes); report() writes both out."""

    def __init__(self, device=None):
        self.timings: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        # the span each span was first opened in (None: at the top)
        self.parents: dict[str, str | None] = {}
        self.notes: dict = {}
        self.profile: dict | None = None
        self._prof = None
        self._cuda = device is not None and device.type == 'cuda'
        self.device = device
        self.peak_rise: dict[str, int] = {}
        self._peak = self._max_allocated()
        self._thread = threading.get_ident()
        self._open = threading.local()      # each thread's open spans
        self._lock = threading.Lock()

    def _max_allocated(self) -> int:
        if not self._cuda:
            return 0
        import torch
        return torch.cuda.max_memory_allocated(self.device)

    def _stack(self) -> list:
        names = getattr(self._open, 'names', None)
        if names is None:
            names = self._open.names = []
        return names

    def step_name(self, step: str) -> str:
        """``<innermost span open on this thread>.<step>``, or ``step``
        where none is open."""
        names = self._stack()
        return f'{names[-1]}.{step}' if names else step

    @contextlib.contextmanager
    def stage(self, name: str):
        names = self._stack()
        if threading.get_ident() == self._thread:
            import torch
            ranged = torch.profiler.record_function(name)
        else:
            ranged = contextlib.nullcontext()
        self.parents.setdefault(name, names[-1] if names else None)
        names.append(name)
        dt = 0.0
        try:
            with ranged:
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    dt = time.perf_counter() - t0
        finally:
            names.pop()
            self.add(name, dt)
            with self._lock:
                peak = self._max_allocated()
                if peak > self._peak:
                    self.peak_rise[name] = (self.peak_rise.get(name, 0)
                                            + peak - self._peak)
                    self._peak = peak

    def add(self, name: str, seconds: float):
        """One call of ``name`` that took ``seconds``, timed elsewhere (the
        align stage's worker thread)."""
        with self._lock:
            self.timings[name] = self.timings.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + 1

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
        """Prints each span's seconds, a step indented under the span it
        ran in; the shares are of the top-level spans' sum (a step's
        seconds are also its stage's)."""
        top = [n for n in self.timings
               if self.parents.get(n) not in self.timings]
        total = sum(self.timings[n] for n in top)
        width = max([24, *(len(n) + 2 for n in self.timings)])
        lines = ['stage timings:']

        def emit(names, depth):
            for name in sorted(names, key=lambda n: -self.timings[n]):
                dt = self.timings[name]
                pct = (f'{100.0 * dt / total if total else 0.0:5.1f}%'
                       if depth == 0 else '')
                lines.append(f'  {"  " * depth}{name:<{width - 2 * depth}s} '
                             f'{dt:8.2f}s  {pct:>6s}  '
                             f'(x{self.counts[name]})')
                emit([n for n in self.timings if n not in top
                      and self.parents[n] == name], depth + 1)

        emit(top, 0)
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


# the timer of the pipeline run in progress (:func:`activate`), which
# :func:`span` records into
_active: StageTimer | None = None


@contextlib.contextmanager
def activate(timer: StageTimer):
    """Make ``timer`` the one that :func:`span` records into while the
    block runs (``pipeline._run_pipeline``: the whole run)."""
    global _active
    prev, _active = _active, timer
    try:
        yield timer
    finally:
        _active = prev


@contextlib.contextmanager
def span(step: str):
    """A step of the work, timed by the active timer (:func:`activate`) as
    ``<innermost span open on this thread>.<step>`` (plain ``step`` where
    none is open); nothing where no timer is active, as for a test or a
    tool that calls a stage's functions directly."""
    timer = _active
    if timer is None:
        yield
        return
    with timer.stage(timer.step_name(step)):
        yield


def count(note: str, **counts: int) -> None:
    """Add ``counts`` to the counters of the note ``note`` of the active
    timer (:func:`activate`), which ``timings.json`` holds under that
    key, summed over the run's calls; nothing where no timer is active."""
    timer = _active
    if timer is None:
        return
    with timer._lock:
        held = timer.notes.setdefault(note, {})
        for key, n in counts.items():
            held[key] = held.get(key, 0) + int(n)
