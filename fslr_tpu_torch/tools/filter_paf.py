"""Standalone PAF filter (stdin -> stdout) for all-vs-all read-overlap QC.

A copy of ``fslr_tpu/tools/filter_paf.py`` (host-only, no device work).

Capability parity with the reference's PAF filter utility
(fslr/filter_paf.py:10-34 semantics): given the minimum
reciprocal-coverage fraction as the first CLI argument, a PAF row survives
when it is not a self-hit, both the query and target alignment spans cover
at least that fraction of their sequence, and the residue-match count is at
least half of both sequence lengths.  A summary of input/kept line counts
goes to stderr.

Typical use: ``minimap2 -x ava-ont reads.fq reads.fq |
python -m fslr_tpu_torch.tools.filter_paf 0.8 > overlaps.paf``
"""

from __future__ import annotations

import sys
from typing import Iterable, Iterator, TextIO

# PAF mandatory columns (0-based): qname, qlen, qstart, qend, strand,
# tname, tlen, tstart, tend, n_matches, block_len, mapq
_QNAME, _QLEN, _QSTART, _QEND = 0, 1, 2, 3
_TNAME, _TLEN, _TSTART, _TEND = 5, 6, 7, 8
_NMATCH = 9

# matching-bases must cover at least this fraction of BOTH sequences
MIN_MATCH_FRACTION = 0.5


def row_passes(fields: list[str], min_coverage: float) -> bool:
    """Decide one parsed PAF row (list of tab-split column strings)."""
    if fields[_QNAME] == fields[_TNAME]:
        return False
    qlen = int(fields[_QLEN])
    tlen = int(fields[_TLEN])
    span_q = int(fields[_QEND]) - int(fields[_QSTART])
    span_t = int(fields[_TEND]) - int(fields[_TSTART])
    if span_q < min_coverage * qlen or span_t < min_coverage * tlen:
        return False
    matches = int(fields[_NMATCH])
    return (matches >= MIN_MATCH_FRACTION * qlen
            and matches >= MIN_MATCH_FRACTION * tlen)


def filter_lines(lines: Iterable[str],
                 min_coverage: float) -> Iterator[tuple[int, int, str]]:
    """Yield (n_seen, n_kept, line) for every surviving PAF line."""
    seen = kept = 0
    for line in lines:
        seen += 1
        if row_passes(line.rstrip('\n').split('\t'), min_coverage):
            kept += 1
            yield seen, kept, line
    # a final sentinel carries the totals (empty payload, never written)
    yield seen, kept, ''


def run(inp: TextIO, out: TextIO, err: TextIO, min_coverage: float) -> None:
    seen = kept = 0
    for seen, kept, line in filter_lines(inp, min_coverage):
        out.write(line)
    print(f'Input alignments: {seen}, kept alignments {kept}', file=err)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    run(sys.stdin, sys.stdout, sys.stderr, float(argv[0]))


if __name__ == '__main__':
    main()
