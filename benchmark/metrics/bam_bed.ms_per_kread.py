"""The BAM and bed layer: ``bam_records`` + ``mapping_table`` +
``bam_write``.  ``bam_records`` and part of ``mapping_table`` are
the seconds of the host worker that builds records and rows while the
next chunk aligns, so they overlap ``align`` and may sum past the
wall.

Milliseconds per 1,000 input reads, summed over the window's samples
from each sample's ``timings.json`` (``instrument.StageTimer``: every
stage waits for the card before its clock stops).  Nothing to read where
no sample ran the stage."""

UNIT = 'ms/kread'
STAGES = ('bam_records', 'mapping_table', 'bam_write')


def read(rec):
    seen = [t['timings_s'][s] for t in rec.timings for s in STAGES
            if s in t['timings_s']]
    if not seen or not rec.reads:
        return None
    return 1e3 * sum(seen) / (rec.reads / 1e3)
