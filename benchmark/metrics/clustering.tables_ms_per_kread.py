"""The clustering layer's tables: query_graph's per-read interval tables,
the interval index, the jobs and the tables' upload: span
``clustering.tables``.

Milliseconds per 1,000 input reads, summed over the window's samples
from each sample's ``timings.json`` (``instrument.StageTimer``: a step
span's host seconds; the stage waits for the card after its last step).
Nothing to read where no sample ran the steps (a program without these
spans)."""

UNIT = 'ms/kread'
STAGES = ('clustering.tables',)


def read(rec):
    seen = [t['timings_s'][s] for t in rec.timings for s in STAGES
            if s in t['timings_s']]
    if not seen or not rec.reads:
        return None
    return 1e3 * sum(seen) / (rec.reads / 1e3)
