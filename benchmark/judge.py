"""The comparison that decides ``correct``: a window's artifacts judged by
what they say, against the planted truth of the generator (``gen.py``)
and the reference FASTA.  Plain NumPy; nothing here imports the program
or reads a file it made other than the artifacts under judgement.

Over every read of each sample the window completed:

* ``filter_reads``: a read of 200 bases or fewer that the filter kept
  (a read is kept when it appears in ``mappings.bed`` or
  ``without_primers.fq``);
* ``filter_counts``: ``filter_counts_summary.csv`` against the outputs:
  kept + dropped = reads, the dropped parts add up, the label counts add
  up to the kept reads, no more reads in the outputs than kept (a kept
  read with no alignment is in neither file) nor of any label than its
  count, and the reads dropped as short are those of 200 bases or fewer
  (less those the junk test took first);
* ``wrong_labels``: a kept read whose primer labels are not the primers
  planted at its ends.

Over a seeded pick of each sample's reads (the longest first):

* ``filter_reads`` also counts a picked read that the concatemer rule
  drops and the filter kept (a primer oligo, forward or reverse
  complemented, scores 28 or more in the read's interior, 100 bases in
  from each end: plain local DP, a gap of ``g`` costing 5 + 2(g - 1)),
  and one that the filter dropped with no such hit and no planted
  tandem repeat of 140 bases or more (whether a repeat is junk is the
  repeat mask's arithmetic, and is not judged);

* ``bad_records``: a BAM record whose CIGAR does not carry its ``AS``
  score on the read and the reference (match 2, mismatch -3, a gap of
  ``g`` costs 5 + 2g), that aligns no base, whose clips and query ops do
  not add up to the read, or whose sequence is not the read trimmed at
  its ends; a trim that cuts past a planted primer into the amplicon;
* ``bed_rows``: a read whose ``mappings.bed`` rows are not its BAM
  records (contig, positions, strand, MAPQ, score, query span, count);
* ``missed_segments``: a planted bread or filling of a fusion read that
  no record covers on its contig and strand over half its length, on
  the reference and on the read;
* ``misplaced_records``: a MAPQ-60 record that lies on no planted
  segment of its read;
* ``suboptimal``: a record, of a seeded pick of the MAPQ-60 ones, whose
  CIGAR scores less than the best global alignment between its ends
  (plain affine DP);

and over the cluster bed:

* ``mixed_clusters``: a cluster that holds fusion reads of more than one
  planted breakpoint group (counted once for each group past the first).

Each number counts faults: the limit of each is 0.
"""

from __future__ import annotations

import collections
import gzip
import os
import struct
import time

import numpy as np

from benchmark import gen

LIMITS = {'filter_reads': 0, 'filter_counts': 0, 'wrong_labels': 0,
          'bad_records': 0, 'bed_rows': 0, 'missed_segments': 0,
          'misplaced_records': 0, 'suboptimal': 0, 'mixed_clusters': 0}
MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND = 2, -3, 5, 2
FIRST_GAP, NEXT_GAP = 5, 2     # the primer scans' gaps: 5 + 2(g - 1)
MIN_LENGTH, END_TRIM, CONCATEMER_SCORE = 200, 100, 28
REPEAT_JUDGED = 140    # a read with a longer planted repeat: the mask's call
SEPARATOR = 64         # unmatchable bases between reads scanned together
COVER = 0.5            # share of a planted segment a record must cover
SURE = 60              # MAPQ of a record that claims its locus
_SEQ = np.full(16, 4, np.uint8)
_SEQ[[1, 2, 4, 8]] = [0, 1, 2, 3]
# CIGAR op codes: M I D N S H P = X
_QUERY = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], bool)
_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], bool)


def read_key(qname: str) -> str:
    """The input read a record's name came from: the name before the
    primer stage's ``.{scores}.{labels}``."""
    return qname.split('.', 1)[0]


def label_of(qname: str) -> str:
    return qname.rsplit('.', 1)[-1]


# ---- the artifacts -------------------------------------------------------

def read_bam(path: str, keep: set) -> tuple[list, dict]:
    """(contig names, {read: [record]}) of the records of the reads in
    ``keep``; a record is a dict of its fields, its CIGAR as lengths and
    op codes, its sequence as codes 0-3 and its ``AS`` tag."""
    with open(path, 'rb') as fh:
        data = gzip.decompress(fh.read())
    l_text = struct.unpack_from('<i', data, 4)[0]
    o = 8 + l_text
    n_ref = struct.unpack_from('<i', data, o)[0]
    o += 4
    names = []
    for _ in range(n_ref):
        ln = struct.unpack_from('<i', data, o)[0]
        names.append(data[o + 4:o + 3 + ln].decode())
        o += 8 + ln
    out: dict = collections.defaultdict(list)
    while o < len(data):
        (size, rid, pos, l_name, mapq, _bin, n_cig, flag,
         l_seq) = struct.unpack_from('<iiiBBHHHi', data, o)
        end = o + 4 + size
        p = o + 36
        qname = data[p:p + l_name - 1].decode()
        key = read_key(qname)
        if key in keep:
            p += l_name
            cig = np.frombuffer(data, '<u4', n_cig, p).astype(np.int64)
            p += 4 * n_cig
            packed = np.frombuffer(data, np.uint8, (l_seq + 1) // 2, p)
            p += (l_seq + 1) // 2 + l_seq
            seq = np.empty(2 * len(packed), np.uint8)
            seq[0::2] = _SEQ[packed >> 4]
            seq[1::2] = _SEQ[packed & 15]
            tags = data[p:end]
            at = tags.find(b'ASi')
            out[key].append(dict(
                qname=qname, rid=rid, pos=pos, mapq=mapq, flag=flag,
                lens=cig >> 4, ops=cig & 15, seq=seq[:l_seq],
                AS=struct.unpack_from('<i', tags, at + 3)[0]
                if at >= 0 else None))
        o = end
    return names, out


def bed_rows(path: str) -> dict:
    """{read: [row fields]} of a mappings bed (header skipped)."""
    rows: dict = collections.defaultdict(list)
    if not os.path.exists(path):
        return rows
    with open(path) as fh:
        next(fh, None)
        for line in fh:
            f = line.rstrip('\n').split('\t')
            rows[read_key(f[3])].append(f)
    return rows


def fastq_names(path: str) -> list[str]:
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [line[1:].split(None, 1)[0]
                for i, line in enumerate(fh) if i % 4 == 0]


def _is_label(key: str) -> bool:
    """A primer-label column of the filter summary: ``<p|False>_<p|False>``
    with each named primer ending in F or R."""
    parts = key.split('_')
    return len(parts) == 2 and all(p == 'False' or p[-1:] in ('F', 'R')
                                   for p in parts)


def filter_summary(path: str) -> dict:
    with open(path) as fh:
        lines = fh.read().splitlines()
    return {k: int(float(v)) for k, v in zip(lines[1].split(','),
                                              lines[2].split(','))
            if k != 'name'}


# ---- alignments ----------------------------------------------------------

def cigar_parts(rec: dict) -> dict:
    """Clips, query and reference spans of a record's CIGAR."""
    lens, ops = rec['lens'], rec['ops']
    clip = (ops == 4) | (ops == 5)
    inner = np.flatnonzero(~clip)
    lead = int(lens[:inner[0]].sum()) if len(inner) else int(lens.sum())
    trail = int(lens[inner[-1] + 1:].sum()) if len(inner) else 0
    ok = ops < len(_QUERY)
    return dict(lead=lead, trail=trail,
                qspan=int(lens[ok & _QUERY[np.minimum(ops, 8)]
                               & ~clip].sum()),
                rspan=int(lens[ok & _REF[np.minimum(ops, 8)]].sum()),
                clip_inside=bool(len(inner)) and bool(
                    clip[inner[0]:inner[-1] + 1].any()),
                n_match=int((ops == 0).sum()),
                known=bool(np.isin(ops, (0, 1, 2, 4, 5)).all()))


def path_score(query: np.ndarray, ref: np.ndarray, lens, ops) -> int:
    """The score of a CIGAR's path over ``query`` and ``ref`` (both from
    the path's first column), clips left out."""
    keep = np.isin(ops, (0, 1, 2))
    lens, ops = lens[keep], ops[keep]
    qstep = np.where(ops != 2, lens, 0)
    rstep = np.where(ops != 1, lens, 0)
    q0 = np.concatenate([[0], np.cumsum(qstep)[:-1]])
    r0 = np.concatenate([[0], np.cumsum(rstep)[:-1]])
    m = ops == 0
    n = lens[m]
    qi = np.repeat(q0[m], n) + _ramp(n)
    ri = np.repeat(r0[m], n) + _ramp(n)
    same = int((query[qi] == ref[ri]).sum())
    gaps = ~m
    return (MATCH * same + MISMATCH * (len(qi) - same)
            - int((GAP_OPEN + GAP_EXTEND * lens[gaps]).sum()))


def _ramp(n: np.ndarray) -> np.ndarray:
    """0..n_k-1 for each k, concatenated."""
    total = int(n.sum())
    starts = np.repeat(np.cumsum(n) - n, n)
    return np.arange(total, dtype=np.int64) - starts


def global_best(query: np.ndarray, ref: np.ndarray) -> int:
    """The best score of a global alignment of ``query`` and ``ref``
    (affine gaps), by a plain DP a row at a time."""
    m, n = len(query), len(ref)
    neg = np.int64(-(1 << 40))
    j = np.arange(n + 1, dtype=np.int64)
    h = np.where(j == 0, 0, -(GAP_OPEN + GAP_EXTEND * j))
    f = np.full(n + 1, neg)
    for i in range(1, m + 1):
        sub = np.where(ref == query[i - 1], MATCH, MISMATCH)
        f = np.maximum(h - (GAP_OPEN + GAP_EXTEND), f - GAP_EXTEND)
        h0 = np.empty(n + 1, np.int64)
        h0[0] = -(GAP_OPEN + GAP_EXTEND * i)
        h0[1:] = np.maximum(h[:-1] + sub, f[1:])
        h0[0] = max(h0[0], f[0])
        # a gap along the reference, opened after any earlier column
        run = np.maximum.accumulate(h0 + GAP_EXTEND * j)
        e = np.full(n + 1, neg)
        e[1:] = run[:-1] - GAP_OPEN - GAP_EXTEND * j[1:]
        h = np.maximum(h0, e)
    return int(h[-1])


def local_best(query: np.ndarray, target: np.ndarray) -> np.ndarray:
    """For each column of ``target``, the best score of a local alignment
    of ``query`` that ends there (plain DP a query base at a time; a gap
    of ``g`` costs 5 + 2(g - 1)); target code 4 matches nothing."""
    n = len(target)
    neg = np.int32(-(1 << 28))
    ramp = NEXT_GAP * np.arange(n + 1, dtype=np.int32)
    h = np.zeros(n + 1, np.int32)
    f = np.full(n + 1, neg)
    best = np.zeros(n + 1, np.int32)
    h0 = np.zeros(n + 1, np.int32)
    e = np.full(n + 1, neg)
    sub = np.empty(n, np.int32)
    for base in query:
        np.copyto(sub, np.where(target == base, np.int32(MATCH),
                                np.int32(MISMATCH)))
        np.maximum(h - FIRST_GAP, f - NEXT_GAP, out=f)
        np.add(h[:-1], sub, out=h0[1:])
        np.maximum(h0[1:], f[1:], out=h0[1:])
        np.maximum(h0, 0, out=h0)
        run = np.maximum.accumulate(h0 + ramp)
        # a gap along the target opened after column k < j:
        # h0[k] - 5 - 2 (j - 1 - k)
        np.subtract(run[:-1], ramp[1:] + (FIRST_GAP - NEXT_GAP), out=e[1:])
        np.maximum(h0, e, out=h)
        np.maximum(best, h, out=best)
    return best[1:]


def concatemer_hits(config: dict, sample: dict, reads: np.ndarray
                    ) -> np.ndarray:
    """Whether each of ``reads`` holds a primer oligo of the panel, either
    strand, scoring at least 28 in its interior."""
    offs = sample['offs']
    parts, owner = [], []
    for k, i in enumerate(reads):
        a, b = offs[i] + END_TRIM, offs[i + 1] - END_TRIM
        if b > a:
            parts += [sample['codes'][a:b], np.full(SEPARATOR, 4, np.uint8)]
            owner += [np.full(b - a, k), np.full(SEPARATOR, -1)]
    hit = np.zeros(len(reads), bool)
    if not parts:
        return hit
    target = np.concatenate(parts)
    owner = np.concatenate(owner)
    best = np.zeros(len(target), np.int32)
    for p in config['primers']:
        oligo = gen.encode(config['oligos'][p])
        for q in (oligo, gen.revcomp(oligo)):
            np.maximum(best, local_best(q, target), out=best)
    at = (best >= CONCATEMER_SCORE) & (owner >= 0)
    hit[np.unique(owner[at])] = True
    return hit


class _Read:
    """One input read and its records as the program wrote them."""

    def __init__(self, sample: dict, i: int, recs: list):
        offs = sample['offs']
        self.codes = sample['codes'][offs[i]:offs[i + 1]]
        self.recs = recs
        self.primary = next((r for r in recs if not r['flag'] & 0x900),
                            None)
        self.trim = None
        if self.primary is not None:
            seq = self.primary['seq']
            fwd = gen.revcomp(seq) if self.primary['flag'] & 16 else seq
            at = bytes(self.codes).find(bytes(fwd))
            if at >= 0:
                self.trim = (at, len(self.codes) - len(fwd) - at)

    def query(self, rec: dict) -> np.ndarray:
        """The trimmed read as the record's CIGAR reads it."""
        a, b = self.trim
        t = self.codes[a:len(self.codes) - b]
        return gen.revcomp(t) if rec['flag'] & 16 else t

    def fwd_span(self, rec: dict, parts: dict) -> tuple[int, int]:
        """The record's query span on the read as generated."""
        a, b = self.trim
        tl = len(self.codes) - a - b
        q0, q1 = parts['lead'], parts['lead'] + parts['qspan']
        if rec['flag'] & 16:
            q0, q1 = tl - q1, tl - q0
        return a + q0, a + q1


def _overlap(a0, a1, b0, b1) -> int:
    return max(0, min(a1, b1) - max(a0, b0))


def judge_read(read: _Read, sample: dict, i: int, ref: gen.Reference,
               segs: dict, rows: list, primer_span: tuple) -> dict:
    """The faults of one picked read's records and bed rows, and its
    MAPQ-60 records (for the DP's pick)."""
    out = collections.Counter()
    sure = []
    if not read.recs:
        out['bed_rows'] += int(bool(rows))
        return dict(out=out, sure=sure)
    if read.trim is None:
        out['bad_records'] += len(read.recs)
        return dict(out=out, sure=sure)
    a, b = read.trim
    # a trim may cut a planted primer, never the amplicon inside it
    if (primer_span[0] is not None and a > primer_span[0]) or \
            (primer_span[1] is not None and b > primer_span[1]):
        out['bad_records'] += 1
    tl = len(read.codes) - a - b
    mine = []
    for rec in read.recs:
        parts = cigar_parts(rec)
        bad = (not parts['known'] or parts['n_match'] == 0
               or parts['clip_inside'] or rec['AS'] is None
               or parts['lead'] + parts['qspan'] + parts['trail'] != tl
               or rec['rid'] < 0 or rec['pos'] < 0
               or rec['pos'] + parts['rspan'] > ref.lengths[rec['rid']])
        if not bad:
            q = read.query(rec)[parts['lead']:parts['lead']
                                + parts['qspan']]
            r = ref.segment(rec['rid'], rec['pos'], parts['rspan'])
            bad = path_score(q, r, rec['lens'], rec['ops']) != rec['AS']
            if not bad and rec['mapq'] >= SURE:
                sure.append((rec, q, r))
        out['bad_records'] += int(bad)
        strand = '-' if rec['flag'] & 16 else '+'
        # the bed gives query spans on the read as the primary reads it
        q0, q1 = parts['lead'], parts['lead'] + parts['qspan']
        if (rec['flag'] ^ read.primary['flag']) & 16:
            q0, q1 = tl - q1, tl - q0
        mine.append((ref.names[rec['rid']] if rec['rid'] >= 0 else '*',
                     rec['pos'] + 1, rec['pos'] + parts['rspan'], q0, q1,
                     q1 - q0, strand, rec['mapq'], rec['AS'],
                     len(read.recs), tl))
        rec['parts'] = parts
    theirs = [(f[0], int(f[1]), int(f[2]), int(f[6]), int(f[7]),
               int(f[5]), f[8], int(f[9]), int(f[11]), int(f[4]),
               int(f[10]))
              for f in rows]
    out['bed_rows'] += int(sorted(mine) != sorted(theirs))

    # planted segments against the records that claim them
    mask = segs['read'] == i
    cat = gen.CATEGORIES[sample['category'][i]]
    spans = []
    for j in np.flatnonzero(mask):
        c, r0, ln = (int(segs['contig'][j]), int(segs['rstart'][j]),
                     int(segs['length'][j]))
        q0, q1 = int(segs['qstart'][j]), int(segs['qend'][j])
        rev = bool(segs['reverse'][j])
        spans.append((c, r0, r0 + ln, rev, q0, q1))
        if cat != 'fusion':
            continue
        got_r = got_q = 0
        for rec in read.recs:
            p = rec.get('parts')
            if p is None or rec['rid'] != c or bool(rec['flag'] & 16) != rev:
                continue
            f0, f1 = read.fwd_span(rec, p)
            got_r += _overlap(rec['pos'], rec['pos'] + p['rspan'], r0,
                              r0 + ln)
            got_q += _overlap(f0, f1, q0, q1)
        out['missed_segments'] += int(got_r < COVER * ln
                                      or got_q < COVER * (q1 - q0))
    if cat == 'fusion':
        for rec, _q, _r in sure:
            p = rec['parts']
            f0, f1 = read.fwd_span(rec, p)
            on = any(rec['rid'] == c and bool(rec['flag'] & 16) == rev
                     and _overlap(rec['pos'], rec['pos'] + p['rspan'],
                                  s0, s1) > 0
                     and _overlap(f0, f1, q0, q1) > 0
                     for c, s0, s1, rev, q0, q1 in spans)
            out['misplaced_records'] += int(not on)
    return dict(out=out, sure=sure)


# ---- a window ------------------------------------------------------------

def picks(sample: dict, seed: int, index: int, k: int) -> np.ndarray:
    """``k`` read indices drawn from the seed, the longest read first."""
    lens = np.diff(sample['offs'])
    longest = int(np.argmax(lens))
    rest = np.delete(np.arange(len(lens)), longest)
    rng = gen.seeded(seed, 0x5EED, index)
    k = min(k, len(lens))
    return np.concatenate([[longest], rng.choice(rest, k - 1,
                                                 replace=False)])


def _primer_spans(config: dict, sample: dict, i: int) -> tuple:
    """How far a trim may reach at each end of read ``i``: to the inner
    end of the primer planted there (None where none was planted)."""
    segs_first = sample['segs']
    m = segs_first['read'] == i
    q0 = segs_first['qstart'][m]
    q1 = segs_first['qend'][m]
    n = int(sample['offs'][i + 1] - sample['offs'][i])
    p1, p2 = sample['primers'][i]
    head = int(q0.min()) if p1 >= 0 and len(q0) else None
    tail = n - int(q1.max()) if p2 >= 0 and len(q1) else None
    return head, tail


def judge_sample(config: dict, ref: gen.Reference, sample: dict,
                 base: str, seed: int, index: int, k_reads: int,
                 k_dp: int) -> tuple[collections.Counter, dict]:
    """The faults of one sample's artifacts, and what was looked at."""
    found: collections.Counter = collections.Counter()
    seen: dict = collections.defaultdict(list)
    clock = {'start': time.perf_counter()}
    names = sample['names']
    n = len(names)
    lens = np.diff(sample['offs'])
    rows = bed_rows(f'{base}.mappings.bed')
    no_primer = fastq_names(f'{base}.without_primers.fq')
    kept = set(rows) | {read_key(q) for q in no_primer}
    is_kept = np.array([nm in kept for nm in names])
    short = lens <= MIN_LENGTH
    found['filter_reads'] = int((short & is_kept).sum())
    seen['filter_reads'] += [f'{names[i]} short kept'
                             for i in np.flatnonzero(short & is_kept)[:3]]

    # labels of every kept read, and the summary's counts
    primers = list(config['primers'])
    labels = collections.Counter()
    wrong = 0
    idx = {nm: i for i, nm in enumerate(names)}
    for key, rs in rows.items():
        lab = label_of(rs[0][3])
        labels[lab] += 1
        i = idx.get(key)
        wrong += int(i is None or lab != gen.planted_label(
            primers, sample['primers'][i]))
    for q in no_primer:
        labels[label_of(q)] += 1
    found['wrong_labels'] = wrong
    summ = filter_summary(f'{base}.filter_counts_summary.csv')
    n_short = int(short.sum())
    counts = {
        'reads': summ['total_kept'] + summ['total_dropped'] - n,
        'dropped': summ['concatemers_dropped'] + summ['junk_seqs_dropped']
        + summ['short_seqs_dropped'] - summ['total_dropped'],
        # a kept read with no alignment is in neither output file
        'kept': max(0, len(kept) - summ['total_kept']),
        'short': max(0, summ['short_seqs_dropped'] - n_short)
        + max(0, n_short - summ['short_seqs_dropped']
              - summ['junk_seqs_dropped']),
        'labels': sum(max(0, c - summ.get(lab, 0))
                      for lab, c in labels.items())
        + abs(sum(v for k, v in summ.items() if _is_label(k))
              - summ['total_kept'])}
    found['filter_counts'] = sum(abs(v) for v in counts.values())
    seen['filter_counts'] = {k: v for k, v in counts.items() if v}

    # the picked reads: the filter's rules, then their records
    clock['outputs'] = time.perf_counter()
    pick = picks(sample, seed, index, k_reads)
    long_ = pick[~short[pick]]
    hit = concatemer_hits(config, sample, long_)
    for i, h in zip(long_.tolist(), hit.tolist()):
        if h and is_kept[i]:
            why = 'a primer oligo inside, kept'
        elif not h and not is_kept[i] and \
                sample['repeat'][i] < REPEAT_JUDGED:
            why = 'no primer oligo inside and no repeat, dropped'
        else:
            continue
        found['filter_reads'] += 1
        seen['filter_reads'].append(
            f'{names[i]} {gen.CATEGORIES[sample["category"][i]]} {why}')
    clock['concatemers'] = time.perf_counter()
    keys = {names[i] for i in pick}
    _contigs, recs = read_bam(f'{base}.bwa_dodi.bam', keys)
    sure = []
    for i in pick:
        read = _Read(sample, int(i), recs.get(names[i], []))
        res = judge_read(read, sample, int(i), ref, sample['segs'],
                         rows.get(names[i], []),
                         _primer_spans(config, sample, int(i)))
        found.update(res['out'])
        for k, v in res['out'].items():
            if v:
                seen[k].append(names[i])
        sure += res['sure']
    clock['records'] = time.perf_counter()
    rng = gen.seeded(seed, 0xD9, index)
    dp = [sure[j] for j in sorted(rng.choice(
        len(sure), min(k_dp, len(sure)), replace=False).tolist())]
    for rec, q, r in dp:
        found['suboptimal'] += int(global_best(q, r) > rec['AS'])

    clock['dp'] = time.perf_counter()

    # clusters hold the reads of one planted group
    crows = bed_rows(f'{base}.mappings.cluster.bed')
    groups: dict = collections.defaultdict(set)
    for key, rs in crows.items():
        i = idx.get(key)
        if i is None or sample['group'][i] < 0:
            continue
        for f in rs:
            if len(f) > 16 and f[16] != '':
                groups[f[16]].add(int(sample['group'][i]))
    found['mixed_clusters'] = sum(len(g) - 1 for g in groups.values())
    seen['mixed_clusters'] = [c for c, g in groups.items() if len(g) > 1]
    looked = dict(reads=n, kept=int(is_kept.sum()), picked=len(pick),
                  records=sum(len(v) for v in recs.values()), dp=len(dp),
                  clusters=len(groups))
    clock['clusters'] = time.perf_counter()
    marks = list(clock.values())
    looked['seconds'] = {k: round(b - a, 3) for k, a, b in zip(
        list(clock)[1:], marks, marks[1:])}
    looked['examples'] = {k: v if isinstance(v, dict) else v[:3]
                          for k, v in seen.items() if v}
    return found, looked


def judge_window(config: dict, ref_path: str, runs: list, seed: int,
                 k_reads: int, k_dp: int) -> tuple[dict, list]:
    """The faults of the window's samples, summed, and what each
    sample's judgement looked at.  ``runs`` holds (index, sample,
    basename of the program's outputs)."""
    ref = gen.Reference(config, ref_path)
    found = {k: 0 for k in LIMITS}
    where = []
    for index, sample, base in runs:
        f, seen = judge_sample(config, ref, sample, base, seed, index,
                               k_reads, k_dp)
        for k, v in f.items():
            found[k] += int(v)
        where.append(dict(seen, **{k: int(v) for k, v in f.items() if v}))
    return found, where
