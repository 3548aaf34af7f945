"""Self-contained BAM writing/reading (BGZF over zlib; no htslib).

Replaces the reference pipeline's samtools/pysam edge (SURVEY.md N4, N8):
the ``{name}.bwa_dodi.bam`` artifact (fslr/main.py:139,166)
is produced directly from the aligner's selected alignments, and
``cluster.get_chromosome_lengths`` (fslr/cluster.py:173-175)
reads contig lengths back from the header on --skip-alignment resume.

Conventions:
  * primary alignments carry SEQ (+QUAL when known) and soft clips;
  * non-primary selected split alignments are flagged supplementary (2048)
    with hard clips, so ``infer_read_length`` (CIGAR including hard clips)
    still recovers the full read length as collect_mapping_info expects
    (collect_mapping_info.py:7-16);
  * AS:i carries the alignment score.

CIGAR fidelity: until the traceback kernel lands, CIGARs are structurally
valid approximations — clips are exact (query coordinates are exact), and
the aligned span is written as M blocks with a single centred I/D making
the reference span consistent.  qstart/qend/rstart/rend/score derived from
these CIGARs are exact; per-base alignment detail is not.
"""

from __future__ import annotations

import dataclasses
import gzip
import struct
import zlib

import numpy as np

_SEQ_CODE = {c: i for i, c in enumerate('=ACMGRSVTWYHKDBN')}
_SEQ_DECODE = '=ACMGRSVTWYHKDBN'
_SEQ_DECODE_ARR = np.frombuffer(_SEQ_DECODE.encode(), np.uint8)
# byte -> nibble LUT (upper+lower case; unknown -> N=15) for vectorized
# sequence packing
_SEQ_LUT = None


def _seq_lut():
    global _SEQ_LUT
    if _SEQ_LUT is None:
        lut = np.full(256, 15, dtype=np.uint8)
        for c, i in _SEQ_CODE.items():
            lut[ord(c)] = i
            lut[ord(c.lower())] = i
        _SEQ_LUT = lut
    return _SEQ_LUT
_CIGAR_OPS = 'MIDNSHP=X'
_CIGAR_CODE = {c: i for i, c in enumerate(_CIGAR_OPS)}

BGZF_EOF = bytes.fromhex(
    '1f8b08040000000000ff0600424302001b0003000000000000000000')


def _bgzf_block(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    # block layout: 12 fixed + 6 extra (XLEN=6) + comp + crc(4) + isize(4)
    total = 12 + 6 + len(comp) + 8
    header = struct.pack('<BBBBIBBHBBHH', 0x1f, 0x8b, 8, 4, 0, 0, 0xff, 6,
                         ord('B'), ord('C'), 2, total - 1)
    footer = struct.pack('<II', zlib.crc32(data) & 0xffffffff,
                         len(data) & 0xffffffff)
    return header + comp + footer


class BgzfWriter:
    def __init__(self, path: str):
        self.fh = open(path, 'wb')
        self.buf = bytearray()

    def write(self, data: bytes):
        self.buf += data
        while len(self.buf) >= 60000:
            self.fh.write(_bgzf_block(bytes(self.buf[:60000])))
            del self.buf[:60000]

    def tell_virtual(self) -> int:
        """BGZF virtual offset of the next byte: (compressed block start
        << 16) | offset-in-uncompressed-block.  Valid because ``write``
        leaves < 60000 < 2^16 bytes buffered."""
        return (self.fh.tell() << 16) | len(self.buf)

    def close(self):
        if self.buf:
            self.fh.write(_bgzf_block(bytes(self.buf)))
        self.fh.write(BGZF_EOF)
        self.fh.close()


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


@dataclasses.dataclass
class BamRecord:
    qname: str
    flag: int
    ref_id: int          # -1 = unmapped
    pos: int             # 0-based leftmost
    mapq: int
    cigar: list[tuple[int, str]]     # [(length, op), ...]
    seq: str             # '' = absent ('*')
    qual: str | None
    tags: dict[str, int]

    @property
    def is_reverse(self):
        return bool(self.flag & 16)

    def infer_read_length(self) -> int:
        return sum(n for n, op in self.cigar if op in 'MIS=XH')

    def reference_span(self) -> int:
        return sum(n for n, op in self.cigar if op in 'MDN=X')


def encode_record(r: BamRecord) -> bytes:
    name = r.qname.encode() + b'\0'
    cigar = b''.join(struct.pack('<I', (n << 4) | _CIGAR_CODE[op])
                     for n, op in r.cigar)
    l_seq = len(r.seq)
    codes = _seq_lut()[np.frombuffer(r.seq.encode(), np.uint8)]
    if l_seq % 2:
        codes = np.append(codes, np.uint8(0))
    seq_bytes = ((codes[0::2] << 4) | codes[1::2]).tobytes()
    if r.qual:
        qual = np.clip(
            np.frombuffer(r.qual.encode(), np.uint8).astype(np.int16) - 33,
            0, 93).astype(np.uint8).tobytes()
    else:
        qual = b'\xff' * l_seq
    tags = b''
    for tag, val in r.tags.items():
        tags += tag.encode() + b'i' + struct.pack('<i', val)
    end = r.pos + max(r.reference_span(), 1)
    fixed = struct.pack(
        '<iiBBHHHiiii', r.ref_id, r.pos, len(name), r.mapq,
        _reg2bin(max(r.pos, 0), max(end, 1)), len(r.cigar), r.flag, l_seq,
        -1, -1, 0)
    body = fixed + name + cigar + bytes(seq_bytes) + qual + tags
    return struct.pack('<I', len(body)) + body


def encode_item(r: BamRecord) -> tuple[int, int, int, bytes]:
    """(ref_id, pos, ref_end, payload) — the compact pre-encoded form the
    streamed pipeline accumulates per chunk (a few hundred bytes/record
    instead of a BamRecord of Python strings)."""
    return (r.ref_id, r.pos, r.pos + max(r.reference_span(), 1),
            encode_record(r))


def _ragged(starts, lens):
    """(flat destination indices, row-of-element, intra-row rank) for
    per-row [starts[i], starts[i]+lens[i]) spans."""
    lens = np.asarray(lens, np.int64)
    tot = int(lens.sum())
    row = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    base = np.concatenate([[0], np.cumsum(lens[:-1])])
    intra = np.arange(tot, dtype=np.int64) - np.repeat(base, lens)
    return np.repeat(np.asarray(starts, np.int64), lens) + intra, row, intra


def _reg2bin_vec(beg, end):
    e = np.asarray(end, np.int64) - 1
    b = np.asarray(beg, np.int64)
    out = np.zeros(len(b), np.int64)
    done = np.zeros(len(b), bool)
    for shift, base in ((14, (1 << 15) - 1), (17, (1 << 12) - 1),
                        (20, (1 << 9) - 1), (23, (1 << 6) - 1),
                        (26, (1 << 3) - 1)):
        hit = ~done & ((b >> shift) == (e >> shift))
        out[hit] = base // 7 + (b[hit] >> shift)
        done |= hit
    return out


# BAM seq nibbles for codes 0-4 (A C G T N)
_NIB = np.array([1, 2, 4, 8, 15], np.uint8)
# complement in code space (N stays N)
_COMP5 = np.array([3, 2, 1, 0, 4], np.uint8)
# phred byte -> BAM qual (clip(q - 33, 0, 93))
_QLUT = np.clip(np.arange(256) - 33, 0, 93).astype(np.uint8)

_BAM_HDR_DT = np.dtype([
    ('bs', '<i4'), ('rid', '<i4'), ('pos', '<i4'), ('lrn', 'u1'),
    ('mapq', 'u1'), ('bin', '<u2'), ('ncig', '<u2'), ('flag', '<u2'),
    ('lseq', '<i4'), ('nrid', '<i4'), ('npos', '<i4'), ('tlen', '<i4')])


def encode_chunk_items(aln, lo, names_buf, name_off, codes, seq_off,
                       quals_buf, qual_off):
    """Vectorized BAM payload assembly for one align chunk — byte-
    identical to per-record :func:`encode_record` (tested), built with
    columnar scatters instead of a Python loop per record (the loop was
    ~80 s of the 1M-read run).

    Args:
      aln: stages.align.Alignments with ``cig_rle`` set — the columnar
        exact-CIGAR form (has, cnt, flat_len, flat_op) in alignment
        order; rows with has=False are handled by the caller's fallback.
      lo: chunk's base read index into the fa arrays.
      names_buf/name_off, codes/seq_off, quals_buf/qual_off: the
        FastxArrays columnar buffers.
    Returns (buf, off, plen, rid, pos, ref_end): one payload buffer plus
    per-record slices, alignment order.
    """
    N = len(aln)
    has, cnt_core, flat_len, flat_op = aln.cig_rle
    assert bool(np.all(has)), 'caller must route no-emit rows to fallback'
    rg = np.asarray(lo + aln.read_idx, np.int64)
    pri = np.asarray(aln.is_primary, bool)
    rev = np.asarray(aln.strand_rev, bool)
    qlen = np.asarray(aln.qlen, np.int64)
    qs = np.asarray(aln.qstart_o, np.int64)
    qe = np.asarray(aln.qend_o, np.int64)
    pos = np.asarray(aln.rstart, np.int64)
    cnt_core = np.asarray(cnt_core, np.int64)
    flat_len = np.asarray(flat_len, np.int64)
    flat_op = np.asarray(flat_op, np.int64)

    # reference span from the CIGAR (M/D consume reference; op codes
    # 0/1/2 = M/I/D), matching encode_record's reference_span()
    core_row = np.repeat(np.arange(N, dtype=np.int64), cnt_core)
    span = np.zeros(N, np.int64)
    np.add.at(span, core_row, np.where(flat_op != 1, flat_len, 0))
    ref_end = pos + np.maximum(span, 1)

    nlen = (name_off[rg + 1] - name_off[rg]).astype(np.int64)
    pre = (qs > 0).astype(np.int64)
    post = (qlen - qe > 0).astype(np.int64)
    ncig = cnt_core + pre + post
    l_seq = np.where(pri, qlen, 0)
    sqb = (l_seq + 1) // 2
    body = 32 + (nlen + 1) + 4 * ncig + sqb + l_seq + 7
    plen = 4 + body
    off = np.concatenate([[0], np.cumsum(plen)])
    total = int(off[-1])
    off = off[:-1]
    buf = np.zeros(total, np.uint8)

    # ---- fixed 36-byte header (block_size + 32-byte core) -------------
    hdr = np.zeros(N, _BAM_HDR_DT)
    hdr['bs'] = body
    hdr['rid'] = np.asarray(aln.chrom_idx, np.int64)
    hdr['pos'] = pos
    hdr['lrn'] = nlen + 1
    hdr['mapq'] = np.asarray(aln.mapq, np.int64)
    hdr['bin'] = _reg2bin_vec(np.maximum(pos, 0), np.maximum(ref_end, 1))
    hdr['ncig'] = ncig
    hdr['flag'] = (np.where(rev, 16, 0) | np.where(pri, 0, 2048))
    hdr['lseq'] = l_seq
    hdr['nrid'] = -1
    hdr['npos'] = -1
    hdr['tlen'] = 0
    buf[off[:, None] + np.arange(36)] = hdr.view(np.uint8).reshape(N, 36)

    # ---- qname + NUL (buffer pre-zeroed) ------------------------------
    dst, row, intra = _ragged(off + 36, nlen)
    buf[dst] = np.frombuffer(names_buf, np.uint8)[
        np.repeat(name_off[rg].astype(np.int64), nlen) + intra]

    # ---- cigar: [pre clip] core ops [post clip] -----------------------
    cig_start = off + 36 + nlen + 1
    cig0 = np.concatenate([[0], np.cumsum(ncig)[:-1]])
    T = int(ncig.sum())
    cig = np.zeros(T, '<u4')
    clip_code = np.where(pri, 4, 5).astype(np.int64)      # S / H
    prer = np.flatnonzero(pre)
    cig[cig0[prer]] = (qs[prer] << 4) | clip_code[prer]
    core0 = np.concatenate([[0], np.cumsum(cnt_core)[:-1]])
    intra_core = np.arange(len(flat_op), dtype=np.int64) \
        - np.repeat(core0, cnt_core)
    cig[cig0[core_row] + pre[core_row] + intra_core] = \
        (flat_len << 4) | flat_op
    postr = np.flatnonzero(post)
    cig[cig0[postr] + pre[postr] + cnt_core[postr]] = \
        ((qlen - qe)[postr] << 4) | clip_code[postr]
    cbytes = cig.view(np.uint8).reshape(T, 4)
    op_base = np.repeat(cig_start, ncig) \
        + 4 * (np.arange(T, dtype=np.int64) - np.repeat(cig0, ncig))
    buf[op_base[:, None] + np.arange(4)] = cbytes

    # ---- seq nibbles + qual (primaries only) --------------------------
    # per-record CONTIGUOUS slice copies + one-LUT vector ops per record:
    # element-level ragged gathers over the ~180M seq/qual positions of a
    # 64k-read chunk cost ~100 s on the 2-core host (measured); slice
    # memcpys + small per-record numpy calls cost ~2 s
    seq_start = cig_start + 4 * ncig
    prim = np.flatnonzero(pri)
    if len(prim):
        qv = np.frombuffer(quals_buf, np.uint8) if len(quals_buf) \
            else None
        so_l = seq_off[rg[prim]].astype(np.int64).tolist()
        lp_l = qlen[prim].tolist()
        rev_l = rev[prim].tolist()
        sst_l = seq_start[prim].tolist()
        qst_l = (seq_start + sqb)[prim].tolist()
        qo_l = (qual_off[rg[prim]].astype(np.int64).tolist()
                if qv is not None else None)
        for t in range(len(prim)):
            o, l, rv = so_l[t], lp_l[t], rev_l[t]
            c = codes[o:o + l]
            if rv:
                c = _COMP5[c[::-1]]
            nib = _NIB[c]
            d = sst_l[t]
            n2 = l // 2
            pk = nib[0:2 * n2:2] << 4
            pk |= nib[1:2 * n2:2]
            buf[d:d + n2] = pk
            if l % 2:
                buf[d + n2] = nib[l - 1] << 4
            qd = qst_l[t]
            if qv is not None:
                q = qv[qo_l[t]:qo_l[t] + l]
                buf[qd:qd + l] = _QLUT[q[::-1] if rv else q]
            else:
                buf[qd:qd + l] = 255

    # ---- AS:i tag -----------------------------------------------------
    tag_start = seq_start + sqb + l_seq
    tbytes = np.zeros(N, np.dtype([('t', 'S3'), ('v', '<i4')]))
    tbytes['t'] = b'ASi'
    tbytes['v'] = np.asarray(aln.score, np.int64)
    buf[tag_start[:, None] + np.arange(7)] = \
        tbytes.view(np.uint8).reshape(N, 7)

    return (buf, off, plen, np.asarray(aln.chrom_idx, np.int64), pos,
            ref_end)


def write_bam(path: str, names: list[str], lengths, records,
              sort_by_coord: bool = True, write_index: bool = False):
    """Write a coordinate-sorted BAM; with ``write_index``, also emit the
    standard ``{path}.bai`` (samtools-index parity: the reference pipeline
    runs ``samtools index`` after sorting, main.py:140,167)."""
    write_bam_items(path, names, lengths,
                    (encode_item(r) for r in records),
                    sort_by_coord=sort_by_coord, write_index=write_index)


def write_bam_items(path: str, names: list[str], lengths, items,
                    sort_by_coord: bool = True,
                    write_index: bool = False):
    """Write pre-encoded ``(ref_id, pos, ref_end, payload)`` items.
    The coordinate sort is a stable key-sort, so items given in the same
    order as ``write_bam``'s records produce a byte-identical file."""
    header_text = ''.join(
        f'@SQ\tSN:{n}\tLN:{int(l)}\n' for n, l in zip(names, lengths))
    header_text = '@HD\tVN:1.6\tSO:coordinate\n' + header_text \
        + '@PG\tID:fslr-tpu\tPN:fslr-tpu\n'
    if sort_by_coord:
        items = sorted(items,
                       key=lambda t: (t[0] if t[0] >= 0 else 1 << 30,
                                      t[1]))
    w = BgzfWriter(path)
    ht = header_text.encode()
    w.write(b'BAM\x01' + struct.pack('<i', len(ht)) + ht
            + struct.pack('<i', len(names)))
    for n, l in zip(names, lengths):
        nb = n.encode() + b'\0'
        w.write(struct.pack('<i', len(nb)) + nb + struct.pack('<i', int(l)))
    spans = []
    for ref_id, pos, ref_end, payload in items:
        vstart = w.tell_virtual()
        w.write(payload)
        if write_index:
            spans.append((ref_id, pos, ref_end, vstart,
                          w.tell_virtual()))
    w.close()
    if write_index:
        write_bai(path + '.bai', len(names), spans)


def write_bai(path: str, n_ref: int, spans):
    """BAI index (SAM spec section 5.2): per reference, R-tree bins of
    chunk virtual-offset ranges + a 16 kb linear index.  ``spans`` =
    (ref_id, beg, end, voff_start, voff_end) per coordinate-sorted
    record."""
    bins = [dict() for _ in range(n_ref)]      # bin -> [chunks]
    linear = [dict() for _ in range(n_ref)]    # window -> min voff
    n_unmapped = 0
    for ref_id, beg, end, vs, ve in spans:
        if ref_id < 0:
            n_unmapped += 1
            continue
        b = _reg2bin(beg, end)
        chunks = bins[ref_id].setdefault(b, [])
        if chunks and chunks[-1][1] == vs:
            chunks[-1] = (chunks[-1][0], ve)   # coalesce adjacent chunks
        else:
            chunks.append((vs, ve))
        lin = linear[ref_id]
        for win in range(beg >> 14, ((end - 1) >> 14) + 1):
            if win not in lin or vs < lin[win]:
                lin[win] = vs
    out = [b'BAI\x01', struct.pack('<i', n_ref)]
    for ref_id in range(n_ref):
        out.append(struct.pack('<i', len(bins[ref_id])))
        for b in sorted(bins[ref_id]):
            chunks = bins[ref_id][b]
            out.append(struct.pack('<Ii', b, len(chunks)))
            for vs, ve in chunks:
                out.append(struct.pack('<QQ', vs, ve))
        lin = linear[ref_id]
        n_intv = (max(lin) + 1) if lin else 0
        out.append(struct.pack('<i', n_intv))
        filled = 0
        for win in range(n_intv):
            filled = lin.get(win, filled) or filled
            out.append(struct.pack('<Q', lin.get(win, filled)))
    out.append(struct.pack('<Q', n_unmapped))
    with open(path, 'wb') as fh:
        fh.write(b''.join(out))


def _reg2bins(beg: int, end: int):
    """All bins that may overlap [beg, end) (SAM spec 5.3)."""
    end -= 1
    res = [0]
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        res.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return res


def _bgzf_block_at(data: bytes, coffset: int) -> tuple[bytes, int]:
    """Decompress the BGZF block starting at compressed offset
    ``coffset``; returns (payload, next block's offset)."""
    xlen, = struct.unpack_from('<H', data, coffset + 10)
    p = coffset + 12
    bsize = None
    endx = p + xlen
    while p < endx:
        si1, si2, slen = data[p], data[p + 1], struct.unpack_from(
            '<H', data, p + 2)[0]
        if si1 == 0x42 and si2 == 0x43:
            bsize = struct.unpack_from('<H', data, p + 4)[0] + 1
        p += 4 + slen
    if bsize is None:
        raise ValueError('BGZF block without BC extra field')
    comp = data[coffset + 12 + xlen:coffset + bsize - 8]
    return zlib.decompress(comp, -15), coffset + bsize


def fetch(bam_path: str, ref_name: str, beg: int, end: int,
          bai_path: str | None = None):
    """Random-access region query via the .bai index (pysam.fetch
    equivalent, self-contained).  Returns overlapping BamRecords."""
    with open(bam_path, 'rb') as fh:
        data = fh.read()
    names, _, hdr_end_voff = _read_bam_header(data)
    if ref_name not in names:
        raise KeyError(ref_name)
    ref_id = names.index(ref_name)
    with open(bai_path or bam_path + '.bai', 'rb') as fh:
        idx = fh.read()
    if idx[:4] != b'BAI\x01':
        raise ValueError('not a BAI index')
    off = 4
    n_ref, = struct.unpack_from('<i', idx, off); off += 4
    chunks = []
    min_lin = 0
    for rid in range(n_ref):
        n_bin, = struct.unpack_from('<i', idx, off); off += 4
        want = set(_reg2bins(beg, end)) if rid == ref_id else None
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from('<Ii', idx, off); off += 8
            for _ in range(n_chunk):
                vs, ve = struct.unpack_from('<QQ', idx, off); off += 16
                if want is not None and b in want:
                    chunks.append((vs, ve))
        n_intv, = struct.unpack_from('<i', idx, off); off += 4
        if rid == ref_id and n_intv > 0:
            win = min(beg >> 14, n_intv - 1)
            min_lin, = struct.unpack_from('<Q', idx, off + 8 * win)
        off += 8 * n_intv
    chunks = sorted(c for c in chunks if c[1] > min_lin)
    out = []
    for vs, ve in chunks:
        vs = max(vs, min_lin)
        for rec in _decode_records_between(data, vs, ve):
            if rec.ref_id != ref_id or rec.pos >= end:
                continue
            if rec.pos + max(rec.reference_span(), 1) > beg:
                out.append(rec)
    seen = set()
    uniq = []
    for r in out:
        key = (r.qname, r.flag, r.pos)
        if key not in seen:
            seen.add(key)
            uniq.append(r)
    uniq.sort(key=lambda r: r.pos)
    return uniq


def _read_bam_header(data: bytes):
    """Header names/lengths from raw BGZF bytes; also returns the virtual
    offset just past the header."""
    payload = bytearray()
    coff = 0
    # decompress until the header (incl. reference list) is complete
    names, lengths = [], []
    need = 12
    while True:
        if len(payload) < need and coff < len(data):
            block, coff = _bgzf_block_at(data, coff)
            payload += block
            continue
        if payload[:4] != b'BAM\x01':
            raise ValueError('not BAM')
        l_text, = struct.unpack_from('<i', payload, 4)
        p = 8 + l_text
        if len(payload) < p + 4:
            need = p + 4
            continue
        n_ref, = struct.unpack_from('<i', payload, p)
        p += 4
        ok = True
        names, lengths = [], []
        for _ in range(n_ref):
            if len(payload) < p + 4:
                ok = False
                break
            l_name, = struct.unpack_from('<i', payload, p); p += 4
            if len(payload) < p + l_name + 4:
                ok = False
                break
            names.append(payload[p:p + l_name - 1].decode())
            p += l_name
            lengths.append(struct.unpack_from('<i', payload, p)[0])
            p += 4
        if ok:
            return names, lengths, p
        need = p + 64
        if coff >= len(data):
            raise ValueError('truncated BAM header')


def _decode_records_between(data: bytes, vstart: int, vend: int):
    """Decode records in the virtual-offset range [vstart, vend)."""
    coff = vstart >> 16
    uoff = vstart & 0xffff
    payload = bytearray()
    first = True
    out = []
    cur = coff
    while cur < len(data) and data[cur:cur + 2] == b'\x1f\x8b':
        block, nxt = _bgzf_block_at(data, cur)
        if first:
            payload += block[uoff:]
            first = False
        else:
            payload += block
        # stop when we have covered vend's block
        if cur >= (vend >> 16):
            break
        cur = nxt
    p = 0
    while p + 4 <= len(payload):
        if len(payload) < p + 4:
            break
        block_size, = struct.unpack_from('<I', payload, p)
        if p + 4 + block_size > len(payload):
            break
        out.append(_decode_record(payload, p + 4, p + 4 + block_size))
        p += 4 + block_size
    return out


def _read_exact(fh, n: int) -> bytes:
    b = fh.read(n)
    while len(b) < n:
        more = fh.read(n - len(b))
        if not more:
            break
        b += more
    return b


def open_bam(path: str):
    """Block-wise BAM open: returns (names, lengths, record generator).

    Decompression is streamed through gzip's incremental reader, so peak
    memory is one record, not the whole decompressed file (the round-1
    read_bam loaded everything; configs 4-5 BAMs are GBs)."""
    fh = gzip.open(path, 'rb')
    magic = _read_exact(fh, 4)
    if magic != b'BAM\x01':
        fh.close()
        raise ValueError(f'{path}: not BAM')
    l_text, = struct.unpack('<i', _read_exact(fh, 4))
    _read_exact(fh, l_text)
    n_ref, = struct.unpack('<i', _read_exact(fh, 4))
    names, lengths = [], []
    for _ in range(n_ref):
        l_name, = struct.unpack('<i', _read_exact(fh, 4))
        nb = _read_exact(fh, l_name)
        names.append(nb[:-1].decode())
        lengths.append(struct.unpack('<i', _read_exact(fh, 4))[0])

    def _records():
        try:
            while True:
                szb = _read_exact(fh, 4)
                if len(szb) < 4:
                    break
                block_size, = struct.unpack('<I', szb)
                body = _read_exact(fh, block_size)
                yield _decode_record(body, 0, block_size)
        finally:
            fh.close()

    return names, lengths, _records()


def stream_raw_records(path: str):
    """Stream (payload, qname, ref_id, pos, ref_end) per record WITHOUT
    decoding seq/qual/tags — payload is the on-disk record bytes
    (block_size prefix included), so record-level filters and merges
    (consensus delete/merge, the samtools merge role) copy bytes instead
    of re-encoding.  Constant memory like open_bam."""
    fh = gzip.open(path, 'rb')
    magic = _read_exact(fh, 4)
    if magic != b'BAM\x01':
        fh.close()
        raise ValueError(f'{path}: not BAM')
    l_text, = struct.unpack('<i', _read_exact(fh, 4))
    _read_exact(fh, l_text)
    n_ref, = struct.unpack('<i', _read_exact(fh, 4))
    names, lengths = [], []
    for _ in range(n_ref):
        l_name, = struct.unpack('<i', _read_exact(fh, 4))
        nb = _read_exact(fh, l_name)
        names.append(nb[:-1].decode())
        lengths.append(struct.unpack('<i', _read_exact(fh, 4))[0])

    _REF_OPS = frozenset('MDN=X')

    def _records():
        try:
            while True:
                szb = _read_exact(fh, 4)
                if len(szb) < 4:
                    break
                block_size, = struct.unpack('<I', szb)
                body = _read_exact(fh, block_size)
                ref_id, pos, l_rn, _mq, _bin, n_cig = struct.unpack_from(
                    '<iiBBHH', body, 0)
                qname = body[32:32 + l_rn - 1].decode()
                span = 0
                if n_cig:
                    vs = np.frombuffer(body, '<u4', n_cig, 32 + l_rn)
                    for v in vs:
                        if _CIGAR_OPS[v & 15] in _REF_OPS:
                            span += int(v) >> 4
                yield (szb + body, qname, ref_id, pos,
                       pos + max(span, 1))
        finally:
            fh.close()

    return names, lengths, _records()


def patch_ref_id(payload: bytes, new_ref_id: int) -> bytes:
    """Rewrite a raw record payload's ref_id in place (contig remap on
    merge)."""
    b = bytearray(payload)
    struct.pack_into('<i', b, 4, new_ref_id)
    return bytes(b)


def read_bam(path: str):
    """Returns (names, lengths, list of records)."""
    names, lengths, it = open_bam(path)
    return names, lengths, list(it)


def _decode_record(data, off: int, end: int) -> BamRecord:
    (ref_id, pos, l_rn, mapq, _bin, n_cig, flag, l_seq, _nr, _np,
     _tl) = struct.unpack_from('<iiBBHHHiiii', data, off)
    p = off + 32
    qname = bytes(data[p:p + l_rn - 1]).decode(); p += l_rn
    if n_cig:
        vs = np.frombuffer(data, '<u4', n_cig, p)
        cigar = [(int(v) >> 4, _CIGAR_OPS[v & 15]) for v in vs]
        p += 4 * n_cig
    else:
        cigar = []
    # nibble-unpack the 4-bit SEQ field vectorized (the per-base Python
    # loop decoded ~1 MB/s; consensus merge streams whole BAMs through
    # here)
    nb = (l_seq + 1) // 2
    if l_seq:
        raw = np.frombuffer(data, np.uint8, nb, p)
        codes = np.empty(2 * nb, np.uint8)
        codes[0::2] = raw >> 4
        codes[1::2] = raw & 15
        seq = _SEQ_DECODE_ARR[codes[:l_seq]].tobytes().decode('ascii')
    else:
        seq = ''
    p += nb
    qual_raw = data[p:p + l_seq]; p += l_seq
    qual = (None if (l_seq == 0 or qual_raw[:1] == b'\xff')
            else (np.frombuffer(qual_raw, np.uint8) + 33)
            .tobytes().decode('ascii'))
    tags = {}
    while p < end:
        tag = bytes(data[p:p + 2]).decode(); typ = chr(data[p + 2]); p += 3
        if typ == 'i':
            tags[tag], = struct.unpack_from('<i', data, p); p += 4
        elif typ in 'cC':
            tags[tag] = data[p]; p += 1
        elif typ in 'sS':
            tags[tag], = struct.unpack_from('<h', data, p); p += 2
        elif typ == 'A':
            tags[tag] = chr(data[p]); p += 1
        elif typ == 'f':
            tags[tag], = struct.unpack_from('<f', data, p); p += 4
        elif typ == 'Z':
            z = data.index(b'\0', p)
            tags[tag] = bytes(data[p:z]).decode(); p = z + 1
        else:
            break  # unsupported array types: stop tag parsing
    return BamRecord(qname=qname, flag=flag, ref_id=ref_id, pos=pos,
                     mapq=mapq, cigar=cigar, seq=seq,
                     qual=qual, tags=tags)


def get_chromosome_lengths(bam_path: str) -> dict[str, int]:
    """Parity with cluster.get_chromosome_lengths (cluster.py:173-175).
    Parses only the BGZF blocks covering the header, not the records."""
    with open(bam_path, 'rb') as fh:
        data = fh.read()
    names, lengths, _ = _read_bam_header(data)
    return dict(zip(names, lengths))


def approx_cigar(qstart: int, qend: int, qlen: int, rspan: int,
                 hard_clips: bool) -> list[tuple[int, str]]:
    """Structurally valid CIGAR for [qstart, qend) of a qlen read covering
    rspan reference bases (see module docstring)."""
    clip = 'H' if hard_clips else 'S'
    qspan = qend - qstart
    m = min(qspan, rspan)
    ops: list[tuple[int, str]] = []
    if qstart > 0:
        ops.append((qstart, clip))
    if qspan == rspan:
        ops.append((m, 'M'))
    else:
        m1 = m // 2
        m2 = m - m1
        mid = ((qspan - m, 'I') if qspan > rspan else (rspan - m, 'D'))
        parts = [(m1, 'M'), mid, (m2, 'M')]
        ops += [p for p in parts if p[0] > 0]
    if qlen - qend > 0:
        ops.append((qlen - qend, clip))
    return ops
