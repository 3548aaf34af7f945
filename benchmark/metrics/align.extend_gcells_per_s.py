"""The align layer's extension rate: the DP cells the banded extension
dispatched in the window (``instrument.cell_counts()['extend']``, the
program's counter, reset at the window's start) over the seconds of
stage ``align``, in billions a second."""

UNIT = 'Gcells/s'


def read(rec):
    cells = rec.cells.get('extend', 0)
    secs = sum(t['timings_s'].get('align', 0.0) for t in rec.timings)
    if not cells or secs <= 0:
        return None
    return cells / secs / 1e9
