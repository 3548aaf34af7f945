"""The index layer: stage ``load_index``, the align stage's wait for the seed
index that a host thread loads (or builds) while the filter runs, with
its upload to the card (``index_upload``, a range inside it).

Milliseconds per 1,000 input reads, summed over the window's samples
from each sample's ``timings.json`` (``instrument.StageTimer``: every
stage waits for the card before its clock stops).  Nothing to read where
no sample ran the stage."""

UNIT = 'ms/kread'
STAGES = ('load_index',)


def read(rec):
    seen = [t['timings_s'][s] for t in rec.timings for s in STAGES
            if s in t['timings_s']]
    if not seen or not rec.reads:
        return None
    return 1e3 * sum(seen) / (rec.reads / 1e3)
