"""The filter layer: stage ``filter_junk`` (gzip inflate, parse, repeat
mask, junk gate, concatemer scan, the filtered file).

Milliseconds per 1,000 input reads, summed over the window's samples
from each sample's ``timings.json`` (``instrument.StageTimer``: every
stage waits for the card before its clock stops).  Nothing to read where
no sample ran the stage."""

UNIT = 'ms/kread'
STAGES = ('filter_junk',)


def read(rec):
    seen = [t['timings_s'][s] for t in rec.timings for s in STAGES
            if s in t['timings_s']]
    if not seen or not rec.reads:
        return None
    return 1e3 * sum(seen) / (rec.reads / 1e3)
