"""The clustering layer: stage ``clustering`` (query graph on the host
path or the device scale path, components, the cluster tables).

Milliseconds per 1,000 input reads, summed over the window's samples
from each sample's ``timings.json`` (``instrument.StageTimer``: every
stage waits for the card before its clock stops).  Nothing to read where
no sample ran the stage."""

UNIT = 'ms/kread'
STAGES = ('clustering',)


def read(rec):
    seen = [t['timings_s'][s] for t in rec.timings for s in STAGES
            if s in t['timings_s']]
    if not seen or not rec.reads:
        return None
    return 1e3 * sum(seen) / (rec.reads / 1e3)
