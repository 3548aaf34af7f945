"""Seeded Nanopore telomere-fusion libraries: the benchmark's traffic.

One general generator for every mix under ``benchmark/mixes/``.  A
configuration (``benchmark/configs/<name>.json``) gives the reference
contigs, their fixed seed and each primer's subtelomere; a mix gives the
shape of a library: reads a sample, the shares of the read categories,
the breakpoint-group size, segment lengths and the error rate.

* :func:`write_reference` writes the contigs as a FASTA of 60-column
  lines, each contig from its own generator seeded by the configuration.
  :class:`Reference` reads any segment of that file back through a
  memory map, without holding the genome.
* :func:`make_sample` builds one sample from a seed: fusion reads in
  breakpoint groups (PCR duplicates sharing every segment's coordinates,
  each with its own sequencing errors), reads with one primer, concatemers,
  tandem-repeat junk and short reads.  Every length is drawn from fixed
  strata, so every seed gives the same multiset of segment lengths (the
  same work) in another order, at other coordinates and with other errors.
  Beside the reads it returns what was planted in each (category, group,
  primers, repeat length, and every reference segment with its place in
  the read after the errors), which ``judge.py`` holds the outputs to.
* :func:`write_sample` writes a sample as MinKNOW writes ``fastq_pass/``:
  gzip files of ``reads_per_file`` reads.
* :func:`write_mappings` writes instead what an earlier run of a sound
  program left for ``--skip-alignment``: the ``mappings.bed`` of the
  planted segments and a BAM of the contigs' header.

Base codes are 0-3 for A, C, G, T.
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ASCII = np.frombuffer(b'ACGT', np.uint8)
_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b'ACGT'):
    _CODE[_c] = _i
    _CODE[_c + 32] = _i
TELOMERE = np.array([3, 3, 0, 2, 2, 2], np.uint8)        # TTAGGG
LINE = 60
CATEGORIES = ('fusion', 'one_primer', 'concatemer', 'junk', 'short')
BREAD, FILLING = 0, 1
SEG_FIELDS = ('read', 'kind', 'contig', 'rstart', 'length', 'reverse',
              'qstart', 'qend')


def encode(seq: str) -> np.ndarray:
    return _CODE[np.frombuffer(seq.encode(), np.uint8)]


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1]


def seeded(*key: int) -> np.random.Generator:
    """A generator for a key of whole numbers of any size (seeds above
    2**63 included), each reduced to 64-bit words."""
    words = []
    for k in key:
        k = int(k)
        words += [k & (2**64 - 1), (k >> 64) & (2**64 - 1), int(k < 0)]
    return np.random.default_rng(np.random.SeedSequence(words))


def contig_codes(config: dict, index: int) -> np.ndarray:
    """Codes of contig ``index`` of ``config['contigs']``."""
    n = int(config['contigs'][index][1])
    return seeded(config['reference_seed'], index).integers(
        0, 4, n, dtype=np.uint8)


def _fasta_lines(codes: np.ndarray) -> np.ndarray:
    n = len(codes)
    rows = -(-n // LINE)
    text = np.empty(rows * LINE, np.uint8)
    text[:n] = ASCII[codes]
    buf = np.full((rows, LINE + 1), ord('\n'), np.uint8)
    buf[:, :LINE] = text.reshape(rows, LINE)
    out = buf.reshape(-1)
    if n % LINE:
        out = np.concatenate([out[:(rows - 1) * (LINE + 1) + n % LINE],
                              out[-1:]])
    return out


def write_reference(config: dict, path: str) -> None:
    """Write the configuration's contigs to ``path`` (written aside, then
    renamed, so a cut write never looks whole)."""
    tmp = f'{path}.partial'
    with open(tmp, 'wb') as fh:
        for i, (name, _n) in enumerate(config['contigs']):
            fh.write(f'>{name}\n'.encode())
            fh.write(_fasta_lines(contig_codes(config, i)).tobytes())
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


class Reference:
    """Segments of a FASTA written by :func:`write_reference`."""

    def __init__(self, config: dict, path: str):
        self.names = [c[0] for c in config['contigs']]
        self.lengths = np.array([c[1] for c in config['contigs']], np.int64)
        self._mm = np.memmap(path, np.uint8, 'r')
        self._start = []
        off = 0
        for name, n in config['contigs']:
            off += len(name) + 2
            self._start.append(off)
            off += n + -(-n // LINE)

    def segment(self, contig: int, start: int, n: int) -> np.ndarray:
        o0 = self._start[contig] + start + start // LINE
        o1 = self._start[contig] + (start + n) + (start + n) // LINE + 1
        raw = np.asarray(self._mm[o0:o1])
        return _CODE[raw[raw != 10][:n]]


def strata(rng: np.random.Generator, n: int, lo: float, hi: float):
    """``n`` whole numbers spread evenly over [lo, hi], in seeded order:
    the same multiset for every seed."""
    if n <= 0:
        return np.zeros(0, np.int64)
    vals = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return rng.permutation(np.rint(vals).astype(np.int64))


def category_counts(mix: dict, n_reads: int) -> dict:
    """Reads of each category in a sample of ``n_reads`` (the remainder of
    the rounding goes to fusions)."""
    counts = {c: int(round(mix['shares'][c] * n_reads))
              for c in CATEGORIES if c != 'fusion'}
    counts['fusion'] = n_reads - sum(counts.values())
    return counts


class _Layout:
    """Draws segments of one sample: breads at a primer's subtelomere,
    fillings anywhere on the contigs."""

    def __init__(self, config, mix, ref: Reference, rng):
        self.config, self.ref, self.rng = config, ref, rng
        self.primers = list(config['primers'])
        self.targets = {p: encode(t) for p, t in config['targets'].items()}
        self.sub = int(mix['subtelomere_bp'])
        self.weights = ref.lengths / ref.lengths.sum()
        self.taken: list = []          # the sample's fillings so far

    def bread(self, primer: str, n: int) -> tuple:
        contig, arm = self.config['primer_sites'][primer]
        ci = self.ref.names.index(contig)
        clen = int(self.ref.lengths[ci])
        lo = 0 if arm == 'p' else clen - self.sub
        start = lo + int(self.rng.integers(0, self.sub - n))
        return ci, start, n

    def filling(self, n: int) -> tuple:
        """A segment anywhere on the contigs outside their subtelomeres
        (so that every seed gives the clustering as much to do) that
        overlaps no filling drawn before it: distinct breakpoints never
        share a locus by chance."""
        while True:
            ci = int(self.rng.choice(len(self.ref.names), p=self.weights))
            start = int(self.rng.integers(
                self.sub, int(self.ref.lengths[ci]) - self.sub - n))
            if not any(c == ci and start < e and s < start + n
                       for c, s, e in self.taken):
                break
        self.taken.append((ci, start, start + n))
        return ci, start, n

    def beside(self, seg, share: float) -> tuple:
        """A segment of ``seg``'s length moved by ``share`` of it along
        its contig (back, where forward would leave the contig)."""
        ci, start, n = seg
        shift = int(round(share * n))
        if start + shift + n > int(self.ref.lengths[ci]):
            shift = -shift
        self.taken.append((ci, start + shift, start + shift + n))
        return ci, start + shift, n

    def codes(self, seg) -> np.ndarray:
        return self.ref.segment(*seg)

    def amplicon(self, p1, p2, bread1, bread2, telo, fillings,
                 filling_rev, partner: bool = True) -> tuple:
        """Primer 1's target, its bread, (TTAGGG)n, the fillings, the
        partner's bread reverse-complemented and, with ``partner``, the
        partner's target reverse-complemented.  Returns the codes and the
        planted reference segments, each (kind, contig, start, length,
        reverse, offset in the codes)."""
        parts = [self.targets[p1], self.codes(bread1),
                 np.tile(TELOMERE, -(-telo // 6))[:telo]]
        segs = [(BREAD, *bread1, 0, len(parts[0]))]
        off = len(parts[0]) + bread1[2] + telo
        for seg, rev in zip(fillings, filling_rev):
            c = self.codes(seg)
            parts.append(revcomp(c) if rev else c)
            segs.append((FILLING, *seg, int(rev), off))
            off += seg[2]
        parts.append(revcomp(self.codes(bread2)))
        segs.append((BREAD, *bread2, 1, off))
        if partner:
            parts.append(revcomp(self.targets[p2]))
        return np.concatenate(parts), segs


def _mutate(rng, codes: np.ndarray, offs: np.ndarray, rate: float,
            split) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Substitutions, insertions and deletions at ``rate`` a base, in the
    proportions ``split``, over reads concatenated in ``codes`` with
    boundaries ``offs``; returns the new codes, the new boundaries and,
    for each old base, the end of what it became in the new codes (so
    old position ``p`` starts at ``ends[p - 1]``)."""
    w = np.asarray(split, np.float64)
    cut = np.rint(rate * np.cumsum(w / w.sum()) * 65536).astype(np.uint16)
    u = rng.integers(0, 65536, len(codes), dtype=np.uint16)
    sub = u < cut[0]
    ins = (u >= cut[0]) & (u < cut[1])
    dele = (u >= cut[1]) & (u < cut[2])
    out = codes.copy()
    out[sub] = (out[sub] + rng.integers(1, 4, int(sub.sum()),
                                        dtype=np.uint8)) % 4
    reps = (1 - dele.view(np.int8) + ins.view(np.int8)).astype(np.int8)
    new = np.repeat(out, reps)
    # the inserted base follows the base it was drawn at
    ends = np.cumsum(reps, dtype=np.int64)
    pos = ends[ins] - 1
    new[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
    lens = np.add.reduceat(reps, offs[:-1], dtype=np.int64) \
        if len(offs) > 1 else np.zeros(0, np.int64)
    empty = offs[1:] == offs[:-1]
    lens[empty] = 0
    return new, np.concatenate([[0], np.cumsum(lens)]).astype(np.int64), \
        ends


def near_groups(mix: dict, nfill: np.ndarray) -> dict:
    """{group: the earlier group it lies beside}: ``mix['near_share']``
    of the complex groups, in pairs of groups with as many fillings, the
    second of each pair beside the first.  The pairs follow the seeded
    order of ``nfill``; their number is the same for every seed."""
    want = int(round(float(mix.get('near_share', 0)) * int(
        (nfill > 0).sum()) / 2))
    out: dict = {}
    for k in sorted(set(nfill[nfill > 0].tolist())):
        same = np.nonzero(nfill == k)[0].tolist()
        for a, b in zip(same[0::2], same[1::2]):
            if len(out) < want:
                out[b] = a
    return dict(sorted(out.items()))


def make_sample(config: dict, mix: dict, ref: Reference, seed: int,
                n_reads: int) -> dict:
    """One library of ``n_reads`` reads from ``seed``.

    Returns ``names`` (list of str), ``codes`` (uint8, reads
    concatenated), ``offs`` (boundaries), ``quals`` (Phred+33 bytes,
    aligned with ``codes``), ``category`` (index into CATEGORIES),
    ``group`` (breakpoint group of a fusion read, else -1), ``primers``
    (the index in ``config['primers']`` of the primer at each end, -1 for
    none), ``repeat`` (the bases of its planted tandem repeat: the
    (TTAGGG)n junction or a junk block) and ``segs``: the planted reference segments of every read, one
    array a field of SEG_FIELDS (``qstart``/``qend`` in the read as
    written, after its errors)."""
    rng = seeded(seed)
    lay = _Layout(config, mix, ref, rng)
    counts = category_counts(mix, n_reads)
    bread_lo, bread_hi = mix['bread_bp']
    fill_lo, fill_hi = mix['filling_bp']
    telo_lo, telo_hi = mix['telomere_bp']
    nf_lo, nf_hi = mix['fillings']
    primers = lay.primers
    pairs = [(a, b) for a in primers for b in primers]
    reads, cats, groups, segs, ends, repeat = [], [], [], [], [], []

    # fusion reads in breakpoint groups of mix['group_size']
    nfus = counts['fusion']
    gsize = int(mix['group_size'])
    ngroups = max(1, -(-nfus // gsize))
    g_b1 = strata(rng, ngroups, bread_lo, bread_hi)
    g_b2 = strata(rng, ngroups, bread_lo, bread_hi)
    g_telo = strata(rng, ngroups, telo_lo, telo_hi)
    n_complex = int(round(mix['complex_share'] * ngroups))
    g_nfill = np.zeros(ngroups, np.int64)
    g_nfill[:n_complex] = strata(rng, n_complex, nf_lo - 0.499,
                                 nf_hi + 0.499)
    g_nfill = rng.permutation(g_nfill)
    g_fill_len = strata(rng, int(g_nfill.sum()), fill_lo, fill_hi)
    g_pair = rng.permutation(np.arange(ngroups) % len(pairs))
    near = near_groups(mix, g_nfill)
    shift = dict(zip(near, strata(rng, len(near), *(1000 * np.asarray(
        mix.get('near_shift', [0, 0])))) / 1000))
    templates, drawn = [], {}
    fi = 0
    for g in range(ngroups):
        p1, p2 = pairs[g_pair[g]]
        if g in near:
            # the partner's fillings, each moved along its contig by a
            # share of its length
            fills = [lay.beside(seg, shift[g]) for seg in drawn[near[g]][0]]
        else:
            fills = [lay.filling(int(n))
                     for n in g_fill_len[fi:fi + g_nfill[g]]]
        fi += g_nfill[g]
        b1, b2 = lay.bread(p1, int(g_b1[g])), lay.bread(p2, int(g_b2[g]))
        rev = drawn[near[g]][1] if g in near else rng.integers(
            0, 2, len(fills))
        drawn[g] = (fills, rev)
        templates.append(lay.amplicon(p1, p2, b1, b2, int(g_telo[g]), fills,
                                      rev))
    member = rng.permutation(np.arange(nfus) % ngroups)
    for g in member:
        reads.append(templates[g][0])
        segs.append(templates[g][1])
        p1, p2 = pairs[g_pair[g]]
        ends.append((primers.index(p1), primers.index(p2)))
        repeat.append(int(g_telo[g]))
        cats.append(0)
        groups.append(int(g))

    def single(partner=True, b1=None, b2=None, telo=None):
        p1, p2 = pairs[int(rng.integers(len(pairs)))]
        codes, sg = lay.amplicon(p1, p2, lay.bread(p1, b1),
                                 lay.bread(p2, b2), telo, [], [],
                                 partner=partner)
        return codes, sg, (primers.index(p1),
                           primers.index(p2) if partner else -1)

    def add(codes, sg, pr, rep=0):
        reads.append(codes)
        segs.append(sg)
        ends.append(pr)
        repeat.append(int(rep))

    n = counts['one_primer']
    for b1, b2, t in zip(strata(rng, n, bread_lo, bread_hi),
                         strata(rng, n, bread_lo, bread_hi),
                         strata(rng, n, telo_lo, telo_hi)):
        add(*single(False, int(b1), int(b2), int(t)), int(t))
    n = counts['concatemer']
    lo, hi = mix['concatemer_bread_bp']
    for b in strata(rng, 4 * n, lo, hi).reshape(-1, 4) if n else []:
        c1, s1, e1 = single(True, int(b[0]), int(b[1]), 0)
        c2, s2, e2 = single(True, int(b[2]), int(b[3]), 0)
        add(np.concatenate([c1, c2]),
            s1 + [sg[:5] + (sg[5] + len(c1),) for sg in s2], (e1[0], e2[1]))
    n = counts['junk']
    blo, bhi = mix['junk_block_bp']
    ulo, uhi = mix['junk_unit_bp']
    for blk, unit, b1, b2 in zip(strata(rng, n, blo, bhi),
                                 strata(rng, n, ulo, uhi),
                                 strata(rng, n, bread_lo, bread_hi),
                                 strata(rng, n, bread_lo, bread_hi)):
        u = rng.integers(0, 4, int(unit), dtype=np.uint8)
        p1, p2 = pairs[int(rng.integers(len(pairs)))]
        bread1, bread2 = lay.bread(p1, int(b1)), lay.bread(p2, int(b2))
        t1 = lay.targets[p1]
        add(np.concatenate([
            t1, lay.codes(bread1),
            np.tile(u, -(-int(blk) // int(unit)))[:int(blk)],
            revcomp(lay.codes(bread2)), revcomp(lay.targets[p2])]),
            [(BREAD, *bread1, 0, len(t1)),
             (BREAD, *bread2, 1, len(t1) + int(b1) + int(blk))],
            (primers.index(p1), primers.index(p2)), int(blk))
    n = counts['short']
    slo, shi = mix['short_bp']
    for ln in strata(rng, n, slo, shi):
        p1 = primers[int(rng.integers(len(primers)))]
        bread1 = lay.bread(p1, 300)
        t1 = lay.targets[p1]
        keep = max(0, int(ln) - len(t1))
        add(np.concatenate([t1, lay.codes(bread1)])[:int(ln)],
            [(BREAD, bread1[0], bread1[1], keep, 0, len(t1))] if keep
            else [], (primers.index(p1), -1))
    for c in CATEGORIES[1:]:
        cats += [CATEGORIES.index(c)] * counts[c]
    groups += [-1] * (n_reads - nfus)

    order = rng.permutation(n_reads)
    reads = [reads[i] for i in order]
    segs = [segs[i] for i in order]
    ends = np.asarray(ends, np.int64).reshape(-1, 2)[order]
    repeat = np.asarray(repeat, np.int64)[order]
    cats = np.asarray(cats, np.int8)[order]
    groups = np.asarray(groups, np.int64)[order]
    lens = np.array([len(r) for r in reads], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    codes, new_offs, base_end = _mutate(rng, np.concatenate(reads), offs,
                                        mix['error_rate'],
                                        mix['error_split'])
    qlo, qhi = mix['quality']
    quals = rng.integers(qlo + 33, qhi + 34, len(codes), dtype=np.uint8)
    ids = rng.integers(0, 2**63, (n_reads, 2), dtype=np.int64)
    hexes = [f'{a:016x}{b:016x}' for a, b in ids.tolist()]
    names = [f'{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}'
             for h in hexes]
    return dict(names=names, codes=codes, offs=new_offs, quals=quals,
                category=cats, group=groups, primers=ends, repeat=repeat,
                segs=_planted(segs, offs, new_offs, base_end))


def _planted(segs: list, offs: np.ndarray, new_offs: np.ndarray,
             base_end: np.ndarray) -> dict:
    """The reads' planted segments as arrays, their offsets in the
    template moved to where the errors put them in the read."""
    rows = [(i, *sg) for i, sl in enumerate(segs) for sg in sl]
    a = np.asarray(rows, np.int64).reshape(-1, 7)
    start = offs[a[:, 0]] + a[:, 6]
    after = np.concatenate([[0], base_end])

    def moved(p):
        return after[p] - new_offs[a[:, 0]]
    return dict(zip(SEG_FIELDS, (a[:, 0], a[:, 1], a[:, 2], a[:, 3],
                                 a[:, 4], a[:, 5].astype(bool),
                                 moved(start), moved(start + a[:, 4]))))


def fastq_bytes(sample: dict, lo: int, hi: int) -> bytes:
    """Reads ``lo``..``hi`` of a sample as FASTQ text."""
    seq = ASCII[sample['codes']]
    q = sample['quals']
    offs = sample['offs']
    parts = []
    for i in range(lo, hi):
        a, b = offs[i], offs[i + 1]
        parts += [b'@', sample['names'][i].encode(), b'\n',
                  seq[a:b].tobytes(), b'\n+\n', q[a:b].tobytes(), b'\n']
    return b''.join(parts)


def write_sample(sample: dict, folder: str, reads_per_file: int,
                 workers: int = 4) -> list[str]:
    """Gzip files of ``reads_per_file`` reads in ``folder`` (MinKNOW's
    ``fastq_pass`` layout); returns their paths."""
    os.makedirs(folder, exist_ok=True)
    n = len(sample['names'])
    spans = [(lo, min(lo + reads_per_file, n))
             for lo in range(0, n, reads_per_file)]

    def one(k):
        lo, hi = spans[k]
        path = os.path.join(folder, f'sample_pass_{k}.fastq.gz')
        with open(path, 'wb') as fh:
            fh.write(gzip.compress(fastq_bytes(sample, lo, hi),
                                   compresslevel=1, mtime=0))
            # on the disk before the window, so that no write-back of the
            # inputs runs inside it
            fh.flush()
            os.fsync(fh.fileno())
        return path

    with ThreadPoolExecutor(max(1, min(workers, len(spans)))) as ex:
        return list(ex.map(one, range(len(spans))))


# ---- an earlier run's mappings (configurations with "input": "mappings")

MAPPING_COLUMNS = ('chrom', 'rstart', 'rend', 'qname', 'n_alignments',
                   'aln_size', 'qstart', 'qend', 'strand', 'mapq', 'qlen',
                   'alignment_score', 'short_anchor<50bp', 'fslr_version',
                   'inferred_by_primer', 'seq')
MAPPED = ('fusion', 'one_primer')      # the reads a sound filter keeps
JITTER = 8             # bases an alignment's end lies off the planted one
SCORE_PER_BASE = (1.4, 1.7)


def mappings(config: dict, sample: dict, seed: int) -> dict:
    """The ``mappings.bed`` that a sound run writes for ``sample``: one row
    a planted segment of every fusion read and read with one primer, in
    the read's order, each end ``JITTER`` bases or fewer off the planted
    one (drawn from ``seed``), MAPQ 60 and a score of 1.4-1.7 a base.
    Returns the columns of MAPPING_COLUMNS and ``read`` (the sample's
    read of each row)."""
    rng = seeded(seed, 77)
    sg = sample['segs']
    cats = sample['category']
    keep = np.isin(cats[sg['read']], [CATEGORIES.index(c) for c in MAPPED])
    idx = np.nonzero(keep)[0]
    idx = idx[np.lexsort((sg['qstart'][idx], sg['read'][idx]))]
    n = len(idx)
    read = sg['read'][idx]
    jit = rng.integers(-JITTER, JITTER + 1, (4, n))
    qlen = np.diff(sample['offs'])[read]
    qs = np.clip(sg['qstart'][idx] + jit[0], 0, qlen - 1)
    qe = np.clip(sg['qend'][idx] + jit[1], qs + 1, qlen)
    lengths = np.array([c[1] for c in config['contigs']], np.int64)
    contig = sg['contig'][idx]
    rs = np.clip(sg['rstart'][idx] + jit[2], 0, lengths[contig] - 1)
    re_ = np.clip(sg['rstart'][idx] + sg['length'][idx] + jit[3], rs + 1,
                  lengths[contig])
    per_read = np.bincount(read, minlength=len(cats))[read]
    score = np.rint((qe - qs) * rng.uniform(*SCORE_PER_BASE, n)).astype(
        np.int64)
    primers = list(config['primers'])
    names = sample['names']
    ends = sample['primers']
    qname = [f'{names[r]}.0.95_0.95.{planted_label(primers, ends[r])}'
             for r in read.tolist()]
    names_of = np.array([c[0] for c in config['contigs']], object)
    return {'chrom': names_of[contig], 'rstart': rs + 1, 'rend': re_,
            'qname': np.array(qname, object), 'n_alignments': per_read,
            'aln_size': qe - qs, 'qstart': qs, 'qend': qe,
            'strand': np.where(sg['reverse'][idx], '-', '+').astype(object),
            'mapq': np.full(n, 60), 'qlen': qlen, 'alignment_score': score,
            'short_anchor<50bp': np.zeros(n, np.int64),
            'fslr_version': np.full(n, '0.1.0', object),
            'inferred_by_primer': np.zeros(n, np.int64),
            'seq': np.full(n, '', object), 'read': read}


def planted_label(primers: list, ends) -> str:
    """The primer stage's label of a read with the primers ``ends`` (their
    indices in ``primers``; -1 for none) at its ends."""
    p1, p2 = int(ends[0]), int(ends[1])
    return f'{primers[p1]}F_{primers[p2] + "R" if p2 >= 0 else "False"}'


def bed_text(table: dict) -> bytes:
    cols = [np.asarray(table[c]).astype(str) for c in MAPPING_COLUMNS]
    lines = ['\t'.join(MAPPING_COLUMNS)]
    lines += ['\t'.join(row) for row in zip(*cols)]
    return ('\n'.join(lines) + '\n').encode()


def _bgzf(payload: bytes) -> bytes:
    """One BGZF block (the BAM format's gzip member with its size)."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    data = c.compress(payload) + c.flush()
    head = struct.pack('<4BI2BH2BHH', 31, 139, 8, 4, 0, 0, 255, 6, 66, 67,
                       2, len(data) + 25)
    return head + data + struct.pack('<II', zlib.crc32(payload),
                                     len(payload))


def bam_header(config: dict) -> bytes:
    """A BAM file of the contigs' header and no record, as the clustering
    reads the contig lengths from an earlier run's BAM."""
    refs = b''.join(struct.pack('<i', len(n) + 1) + n.encode() + b'\0'
                    + struct.pack('<i', int(ln))
                    for n, ln in config['contigs'])
    text = b'@HD\tVN:1.6\tSO:unsorted\n'
    body = (b'BAM\1' + struct.pack('<i', len(text)) + text
            + struct.pack('<i', len(config['contigs'])) + refs)
    return _bgzf(body) + _bgzf(b'')


def write_mappings(config: dict, sample: dict, folder: str, seed: int,
                   name: str = 'S') -> dict:
    """``{name}.mappings.bed`` and ``{name}.bwa_dodi.bam`` (its header) in
    ``folder``, as an earlier run left them; returns the table."""
    os.makedirs(folder, exist_ok=True)
    table = mappings(config, sample, seed)
    for path, data in ((f'{name}.mappings.bed', bed_text(table)),
                       (f'{name}.bwa_dodi.bam', bam_header(config))):
        with open(os.path.join(folder, path), 'wb') as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
    return table
