"""Mapping table: alignments -> ``{name}.mappings.bed``, without pandas.

Counterpart of ``fslr_tpu/stages/mapping_table.py`` (the reference's
collect_mapping_info).  A table is a dict of equal-length numpy columns in
output order.  Per read: the designated primary sets the strand that other
alignments are flipped onto; rstart/rend are 1-based; single-alignment
reads with a primer label and <= 5 bp gap at one end get an inferred
primer pseudo-alignment; ``short_anchor<50bp`` flags reads whose first or
last alignment (by qstart) spans < 50 bp; rows sort by n_alignments
descending, then qname, then qstart, stably.

``write_mappings_bed`` writes the TSV byte for byte as pandas ``to_csv``
(index=False, sep='\\t') would: ints as ints, float columns as ``1.0`` /
empty for NaN, booleans as True/False, minimal csv quoting.
"""

from __future__ import annotations

import csv

import numpy as np

import fslr_tpu_torch
from fslr_tpu_torch.stages.align import Alignments

COLUMNS = ['chrom', 'rstart', 'rend', 'qname', 'n_alignments', 'aln_size',
           'qstart', 'qend', 'strand', 'mapq', 'qlen', 'alignment_score',
           'short_anchor<50bp', 'fslr_version', 'inferred_by_primer', 'seq']


def build_regions(regions_path):
    regions = {}
    if not regions_path:
        return regions
    with open(regions_path) as fh:
        for line in fh:
            f = line.strip().split('\t')
            if len(f) < 3:
                continue
            regions.setdefault(f[0], []).append((int(f[1]), int(f[2])))
    return regions


def _overlaps(regions, chrom, start, end):
    """pd.Interval default closed='right' overlap: (a, b] vs (c, d]
    intersect iff a < d and c < b."""
    return any(start < e and s < end for (s, e) in regions.get(chrom, ()))


def _obj(values) -> np.ndarray:
    values = list(values)
    out = np.empty(len(values), object)
    out[:] = values
    return out


def _qname_order(qname):
    """Sort codes of qname in Python string order (a lexsort key)."""
    return np.unique(qname, return_inverse=True)[1].reshape(-1)


def sort_table(table: dict) -> dict:
    """Stable sort by n_alignments descending, then qname, then qstart."""
    codes = _qname_order(table['qname'])
    order = np.lexsort((table['qstart'], codes, -table['n_alignments']))
    return {k: v[order] for k, v in table.items()}


def concat_tables(tables: list[dict]) -> dict:
    """Row-wise concatenation (ints meeting NaN floats become float64)."""
    return {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}


def mapping_table(aln: Alignments, qnames: list[str], seqs: list[str],
                  chrom_names: list[str], regions_path: str | None,
                  primers: dict[str, str]) -> dict:
    """Build the mappings table.  ``qnames``/``seqs`` are indexed by
    aln.read_idx; ``primers`` maps primer name -> primer_seq."""
    version = fslr_tpu_torch.__version__
    regions = build_regions(regions_path)
    cols = COLUMNS + (['overlaps_region'] if regions else [])
    n = len(aln)
    if n == 0:
        return {c: np.zeros(0, object) for c in cols}

    ridx = aln.read_idx.astype(np.int64)
    uniq, inv, counts = np.unique(ridx, return_inverse=True,
                                  return_counts=True)
    pris = np.flatnonzero(aln.is_primary)
    pri_reads = ridx[pris]
    ps = np.argsort(pri_reads)
    if len(pris) != len(uniq) or np.any(pri_reads[ps] != uniq):
        raise RuntimeError('primary flag problem: reads without exactly '
                           'one primary alignment')
    pri_rev = aln.strand_rev[pris[ps][inv]]
    n_aligns = counts[inv].astype(np.int64)
    qlen = aln.qlen.astype(np.int64)
    qs_o = aln.qstart_o.astype(np.int64)
    qe_o = aln.qend_o.astype(np.int64)
    flip = pri_rev != aln.strand_rev        # onto the primary's strand
    qstart = np.where(flip, qlen - qe_o, qs_o)
    qend = np.where(flip, qlen - qs_o, qe_o)
    rstart = aln.rstart.astype(np.int64) + 1
    rend = aln.rend.astype(np.int64) + 1
    chrom_col = _obj(chrom_names)[aln.chrom_idx]
    # the BAM's 4-bit SEQ reads back uppercase: the primary's sequence
    seq_col = np.full(n, '', object)
    for i in pris:
        seq_col[i] = seqs[int(ridx[i])].upper()
    cols_all = {
        'qname': _obj(qnames[int(r)] for r in ridx),
        'n_alignments': n_aligns, 'chrom': chrom_col,
        'rstart': rstart, 'rend': rend,
        'strand': _obj(np.where(aln.strand_rev, '-', '+')),
        'qstart': qstart, 'qend': qend, 'qlen': qlen,
        'aln_size': qend - qstart, 'mapq': aln.mapq.astype(np.int64),
        'alignment_score': aln.score.astype(np.int64), 'seq': seq_col,
        'fslr_version': np.full(n, version, object),
        'inferred_by_primer': np.zeros(n, np.int64),
    }
    if regions:
        cols_all['overlaps_region'] = np.array(
            [int(_overlaps(regions, chrom_col[i], int(rstart[i]),
                           int(rend[i]))) for i in range(n)], np.int64)

    multi = n_aligns > 1
    parts = [{k: v[multi] for k, v in cols_all.items()}]

    # single-alignment reads: inferred primer pseudo-alignments, start
    # pseudos before their read's row and end pseudos after it
    singles = np.flatnonzero(~multi)
    if len(singles):
        sd = {k: v[singles] for k, v in cols_all.items()}
        labels = [str(q).rsplit('.', 1)[-1].split('_') for q in sd['qname']]
        l1 = [lab[0] for lab in labels]
        l2 = [lab[1] if len(lab) > 1 else None for lab in labels]
        p1 = [x.rstrip('FR') for x in l1]
        p2 = [x.rstrip('FR') if x is not None else None for x in l2]
        ql = sd['qlen']
        both_gaps = (sd['qstart'] > 5) & (ql - sd['qend'] > 5)
        m1 = ~both_gaps & np.array([x != 'False' for x in p1])
        m2 = ~both_gaps & ~m1 & np.array([x != 'False' for x in p2])
        sd['n_alignments'] = np.where(m1 | m2, 2, sd['n_alignments'])

        def _pseudo(mask, pser, lser, at_start: bool):
            idx = np.flatnonzero(mask)
            if not len(idx):
                return None
            k = len(idx)
            pnames = [pser[i] for i in idx]
            plens = np.array([len(primers[x]) for x in pnames], np.int64)
            zeros = np.zeros(k, np.int64)
            d = {'qname': sd['qname'][idx],
                 'n_alignments': np.full(k, 2, np.int64),
                 'chrom': _obj(pnames), 'rstart': zeros, 'rend': zeros,
                 'strand': _obj('-' if lser[i][-1] == 'R' else '+'
                                for i in idx),
                 'qstart': zeros if at_start else ql[idx] - plens,
                 'qend': plens if at_start else ql[idx],
                 'qlen': ql[idx], 'aln_size': zeros, 'mapq': zeros,
                 'alignment_score': zeros, 'seq': np.full(k, '', object),
                 'fslr_version': np.full(k, version, object),
                 'inferred_by_primer': np.ones(k, np.int64)}
            if regions:
                # the reference's pseudo rows lack overlaps_region, so the
                # column turns float64 with NaN there
                d['overlaps_region'] = np.full(k, np.nan)
            return d

        pre = _pseudo(m1, p1, l1, True)
        post = _pseudo(m2, p2, l2, False)
        parts += [p for p in (pre, sd, post) if p is not None]
    table = concat_tables(parts)

    # stable sort by (qname, qstart); short-anchor flag per read
    order = np.lexsort((table['qstart'], _qname_order(table['qname'])))
    table = {k: v[order] for k, v in table.items()}
    qn = table['qname']
    sizes = table['aln_size']
    starts_m = np.ones(len(qn), bool)
    starts_m[1:] = qn[1:] != qn[:-1]
    ends_m = np.empty(len(qn), bool)
    ends_m[:-1] = starts_m[1:]
    ends_m[-1] = True
    gidx = np.cumsum(starts_m) - 1
    bad = (sizes[starts_m] < 50) | (sizes[ends_m] < 50)
    table['short_anchor<50bp'] = bad[gidx].astype(np.int64)
    table = sort_table(table)
    return {c: table[c] for c in cols}


def _cells(col: np.ndarray) -> list[str]:
    if col.dtype.kind == 'f':
        return ['' if np.isnan(x) else str(x) for x in col.tolist()]
    return ['' if isinstance(x, float) and np.isnan(x) else str(x)
            for x in col.tolist()]


def write_mappings_bed(table: dict, path: str):
    with open(path, 'w', newline='') as fh:
        w = csv.writer(fh, delimiter='\t', lineterminator='\n')
        w.writerow(list(table))
        w.writerows(zip(*(_cells(v) for v in table.values())))


# ---------------------------------------------------------------------------
# Standalone mode: BAM -> mappings.bed (the reference's collect_mapping_info
# --bam; fslr_tpu.stages.mapping_table.mapping_table_from_bam)
# ---------------------------------------------------------------------------

def _clip_query_span(cigar: list[tuple[int, str]]):
    """(qstart, qend, qlen) in record orientation from the CIGAR's clips,
    hard clips included."""
    qlen = sum(n for n, op in cigar if op in 'MIS=XH')
    start = cigar[0][0] if cigar and cigar[0][1] in 'SH' else 0
    end = qlen - (cigar[-1][0] if cigar and cigar[-1][1] in 'SH' else 0)
    return start, end, qlen


def mapping_table_from_bam(bam_path: str, regions_path: str | None = None,
                           primers: dict[str, str] | None = None) -> dict:
    """The mappings table of any BAM: host work only, no device.

    Unmapped records (flag 4) are skipped.  Query spans come from the
    CIGAR clips; ``rend`` = pos + max(reference span, 1) - 1 (0-based).
    A read's primary is the first record with the largest AS among those
    neither secondary (0x100) nor supplementary (0x800); its strand and
    sequence give the read's forward sequence.  A read with no such
    record raises ValueError.  ``primers`` (name -> primer sequence)
    defaults to the shipped panel's."""
    from fslr_tpu_torch.encode import revcomp_str
    from fslr_tpu_torch.io import bam as bamio

    names, _lengths, records = bamio.open_bam(bam_path)
    read_of: dict[str, int] = {}
    best: list = []          # per read: (AS, row, seq, reverse) or None
    rows = []                # per record: read, contig, pos, rend, reverse,
    #                          qstart, qend, qlen, mapq, AS
    for a in records:
        if a.flag & 4:
            continue
        g = read_of.setdefault(a.qname, len(read_of))
        if g == len(best):
            best.append(None)
        score = a.tags.get('AS', 0)
        rev = bool(a.flag & 16)
        if not a.flag & 0x900 and (best[g] is None or score > best[g][0]):
            best[g] = (score, len(rows), a.seq, rev)
        rows.append((g, a.ref_id, a.pos,
                     a.pos + max(a.reference_span(), 1) - 1, rev,
                     *_clip_query_span(a.cigar), a.mapq, score))
    qnames = list(read_of)
    seqs = []
    for g, b in enumerate(best):
        if b is None:
            raise ValueError(
                f'{bam_path}: read {qnames[g]} has no primary-eligible '
                f'alignment (all records secondary/supplementary)')
        seqs.append(revcomp_str(b[2]) if b[3] else b[2])
    cols = (np.array(rows, np.int64).reshape(-1, 10).T if rows
            else np.zeros((10, 0), np.int64))
    is_primary = np.zeros(len(rows), bool)
    is_primary[[b[1] for b in best]] = True
    i32 = np.int32
    aln = Alignments(
        read_idx=cols[0].astype(i32), chrom_idx=cols[1].astype(i32),
        rstart=cols[2].astype(i32), rend=cols[3].astype(i32),
        strand_rev=cols[4].astype(bool), qstart_o=cols[5].astype(i32),
        qend_o=cols[6].astype(i32), qlen=cols[7].astype(i32),
        mapq=cols[8].astype(i32), score=cols[9].astype(i32),
        is_primary=is_primary, overlaps_region=np.zeros(len(rows), bool))
    if primers is None:
        from fslr_tpu_torch.panel import load_panel
        primers = load_panel().seqs
    return mapping_table(aln, qnames, seqs, names, regions_path, primers)


def _main(argv=None):
    """``python -m fslr_tpu_torch.stages.mapping_table BAM OUT
    [--regions BED]``: a mappings.bed from a BAM, on the host (there is
    no --device: this mode does no device work)."""
    import argparse
    ap = argparse.ArgumentParser(
        prog='python -m fslr_tpu_torch.stages.mapping_table',
        description='Rebuild a mappings.bed from a BAM (the reference '
                    'collect_mapping_info standalone mode).')
    ap.add_argument('bam', help='BAM file to assess')
    ap.add_argument('out', help='output bed/TSV path')
    ap.add_argument('--regions', default=None,
                    help='bed of regions for the overlaps_region column')
    args = ap.parse_args(argv)
    write_mappings_bed(mapping_table_from_bam(args.bam, args.regions),
                       args.out)
    print('Done')


if __name__ == '__main__':
    _main()
