"""Per-stage timing + optional profiler traces.

The reference's observability is stderr prints (SURVEY.md section 5.1);
here every pipeline stage is timed first-class: ``StageTimer`` collects
wall-clock per stage, prints a summary, and writes
``{basename}.timings.json``.  Copied from ``fslr_tpu/instrument.py``
without its jax.profiler hooks.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time


# ---------------------------------------------------------------------------
# DP-cell accounting (BASELINE.md target table: "Alignment DP cell-updates/s
# measured & reported alongside reads/s").  Stage code calls add_cells() with
# the number of useful dynamic-programming cell updates it dispatched (SW
# primer scans, banded extension, traceback); bench.py divides by stage wall
# time.  A plain module counter: the pipeline dispatches from one thread.

_dp_cells: dict = {}


def add_cells(n: int, tag: str = 'dp') -> None:
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
    def __init__(self):
        self.timings: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, path: str | None = None):
        total = sum(self.timings.values())
        lines = ['stage timings:']
        for name, dt in sorted(self.timings.items(), key=lambda x: -x[1]):
            pct = 100.0 * dt / total if total else 0.0
            lines.append(f'  {name:<24s} {dt:8.2f}s  {pct:5.1f}%  '
                         f'(x{self.counts[name]})')
        print('\n'.join(lines), file=sys.stderr)
        if path:
            with open(path, 'w') as fh:
                json.dump({'timings_s': self.timings,
                           'counts': self.counts}, fh, indent=1)
