"""Alignment stage: seed -> candidate bands -> banded extension -> selection
-> traceback emit -> z-drop split.

Counterpart of ``fslr_tpu/stages/align.py``.  Per read batch, against
each source (the reference, or each shard of a sharded one, and the
masked reference when one is given):

  1. seeding of both strands against the device-resident index
     (ops/seed.py) gives candidate diagonal bands;
  2. near-diagonal bands of one (read, strand) merge, and bwa-style chain
     filtering drops shadowed bands (host numpy); a sharded index first
     keeps one budget of bands per (read, strand) across its shards and
     filters chains across them;
  3. the score-only banded extension, forward then reversed
     (ops/banded.banded_extend_score), gives each band's score, ends and
     begins;
  4. the candidates of every source pooled (shard contigs renumbered into
     the reference's, masked contigs by name), the dodi-equivalent
     selection DP (ops/selection.py) with optional region bias picks each
     read's alignments; the first best-scoring one
     is primary; MAPQ follows the bwa-mem single-end model;
  5. with ``exact_cigars`` (the default), the traceback extension
     (ops/traceback.banded_extend) runs on the selected alignments only
     against each one's own source genome and gives their CIGARs
     (columnar RLE) and walk-derived begins; then the z-drop split cuts
     alignments at indel runs that bwa's z-drop would not have bridged
     (host numpy, replayed against the source's codes).

Alignment records carry query coordinates in record orientation plus the
strand, as the JAX package's do.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from fslr_tpu_torch.config import AlignConfig, PipelineConfig
from fslr_tpu_torch.encode import _COMP, bucket_length
from fslr_tpu_torch.index.reference import Reference, SeedIndex
from fslr_tpu_torch.ops import banded, seed, selection, traceback
from fslr_tpu_torch.parallel import dispatch

_SLICE_BUCKETS = (256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096,
                  6144, 8192, 12288, 16384, 24576, 32768)
_SEED_KEYS = ('valid', 'count', 'diag', 'qmin', 'qmax', 'wsum')
# Largest per-seed occurrence cap that uses the packed seed table
# (4^k * (1 + C) int32 on the device); larger caps read counts/positions.
_MAX_TABLE_C = 8
_SEED_HITS = 1 << 23      # rows x sampled seeds x cap per seeding call
_EMIT_BITS = 1 << 30      # traceback codes per emit call: SL x 64 B a row


@dataclasses.dataclass
class Alignments:
    """Flat arrays over the selected alignments."""
    read_idx: np.ndarray      # index into the batch's reads
    chrom_idx: np.ndarray     # contig index into Reference.names
    rstart: np.ndarray        # 0-based inclusive, contig-local
    rend: np.ndarray          # 0-based inclusive
    strand_rev: np.ndarray    # bool, True = reverse strand
    qstart_o: np.ndarray      # record-orientation query start (0-based)
    qend_o: np.ndarray        # record-orientation query end (exclusive)
    qlen: np.ndarray          # full read length
    score: np.ndarray         # alignment score (unbiased)
    mapq: np.ndarray
    is_primary: np.ndarray    # bool
    overlaps_region: np.ndarray  # bool (all False without --regions)
    # columnar exact-CIGAR RLE (has, cnt, flat_len, flat_op), op codes
    # 0/1/2 = M/I/D -- the form io/bam.encode_chunk_items consumes
    cig_rle: tuple | None = None

    def __len__(self):
        return len(self.read_idx)

    def cigar_lists(self):
        """Per-alignment [(len, op_char), ...] core CIGARs (None where no
        emit stream exists), from cig_rle."""
        if self.cig_rle is None:
            return None
        has, cnt, flat_len, flat_op = self.cig_rle
        out = [None] * len(self)
        ends = np.cumsum(cnt)
        starts = ends - cnt
        ll = flat_len.tolist()
        oo = flat_op.tolist()
        for i in np.flatnonzero(has):
            out[i] = [(ll[t], 'MID'[oo[t]])
                      for t in range(starts[i], ends[i])]
        return out


def empty_alignments() -> Alignments:
    return Alignments(*[np.zeros(0, dt) for dt in
                        (np.int32,) * 4 + (bool,) + (np.int32,) * 5
                        + (bool, bool)])


@dataclasses.dataclass
class _Cols:
    """Struct of equal-length numpy columns."""

    def __len__(self):
        return len(getattr(self, dataclasses.fields(self)[0].name))

    def take(self, idx):
        return type(self)(*(getattr(self, f.name)[idx]
                            for f in dataclasses.fields(self)))


@dataclasses.dataclass
class Cands(_Cols):
    """Candidate bands, one row per (read, strand, diagonal band)."""
    ridx: np.ndarray     # int64 read index
    srev: np.ndarray     # bool, reverse strand
    dga: np.ndarray      # int64 diagonal anchor (global ref coords)
    cnt: np.ndarray      # int64 seed count
    qmn: np.ndarray      # int64 min seed query pos (strand orientation)
    qmx: np.ndarray      # int64 max seed query pos
    wcnt: np.ndarray     # int64 occurrence-sampling-corrected seed weight

    @staticmethod
    def concat(parts):
        return Cands(*(np.concatenate([getattr(p, f.name) for p in parts])
                       for f in dataclasses.fields(Cands)))


def _empty_cands() -> Cands:
    return Cands(*(np.zeros(0, bool if f.name == 'srev' else np.int64)
                   for f in dataclasses.fields(Cands)))


@dataclasses.dataclass
class CandAln(_Cols):
    """Candidate alignments before selection (score pass coordinates),
    with the extension geometry that the traceback emit of the selected
    rows re-runs: window and contig bounds in the coordinates of the
    source genome ``genomes[src]`` (device codes, host codes), one entry
    per source (reference, shard or masked reference)."""
    read_idx: np.ndarray
    strand_rev: np.ndarray
    chrom_idx: np.ndarray
    rstart: np.ndarray       # contig-local 0-based inclusive
    rend: np.ndarray
    qstart_o: np.ndarray     # record orientation
    qend_o: np.ndarray       # exclusive
    qlen: np.ndarray
    score: np.ndarray
    ext_ws: np.ndarray       # window start
    ext_qlo: np.ndarray      # query slice start (strand orientation)
    ext_qlen: np.ndarray     # kernel qlens value (slice length)
    ext_sl: np.ndarray       # slice bucket (kernel row width)
    ext_cmin: np.ndarray     # contig lower bound
    ext_cmax: np.ndarray     # contig upper bound
    src: np.ndarray          # int32 index into genomes
    genomes: list            # (device codes, host codes) per source

    def take(self, idx):
        return CandAln(*(getattr(self, f.name)[idx]
                         for f in dataclasses.fields(self)[:-1]),
                       self.genomes)

    @staticmethod
    def concat(parts):
        """The rows of ``parts`` in order, ``src`` renumbered into the
        joined list of genomes."""
        parts = [p for p in parts if len(p)]
        if not parts:
            return _empty_cand_aln()
        genomes, cols = [], []
        for p in parts:
            cols.append([getattr(p, f.name)
                         for f in dataclasses.fields(p)[:-2]]
                        + [p.src + len(genomes)])
            genomes.extend(p.genomes)
        return CandAln(*(np.concatenate(c) for c in zip(*cols)), genomes)


def _empty_cand_aln() -> CandAln:
    dtypes = {'strand_rev': bool, 'ext_qlen': np.int32, 'ext_sl': np.int32,
              'src': np.int32}
    return CandAln(*(np.zeros(0, dtypes.get(f.name, np.int64))
                     for f in dataclasses.fields(CandAln)[:-1]), [])


# ---------------------------------------------------------------------------
# Device-resident index
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceIndex:
    """One reference's genome and seed index as device tensors, or one
    shard's (the port's own cache; the JAX package's SeedIndex is never
    written)."""
    genome: torch.Tensor          # (G,) uint8 codes
    counts: torch.Tensor          # (4^k + 1,) int32 cumulative offsets
    positions: torch.Tensor       # (n,) int32 k-mer-sorted positions
    occ_cap: int                  # per-seed occurrence cap C
    table: torch.Tensor | None    # (4^k, 1 + C) int32 packed seed table
    ref: Reference                # the host reference these tensors hold
    contig_base: int = 0          # index of ref's first contig in the
                                  # full reference


def _occ_cap(sidx: SeedIndex, acfg: AlignConfig) -> int:
    """Per-seed occurrence cap: the 99.9th percentile of the nonzero
    k-mer occupancy, floor 4, ceiling max_kmer_occ."""
    occ = np.diff(sidx.counts)
    nz = occ[occ > 0]
    p = int(np.percentile(nz, 99.9)) if nz.size else 1
    return int(min(acfg.max_kmer_occ, max(4, p)))


def _build_table(counts, positions, C: int):
    """Packed seed table, built on the device with the integer arithmetic
    of fslr_tpu.stages.align._build_table_device: column 0 the k-mer's
    occurrence count, columns 1..C its evenly sampled positions."""
    occ = counts[1:] - counts[:-1]
    starts = counts[:-1]
    n = occ.shape[0]
    use = torch.clamp_max(occ, C)
    step = torch.clamp_min(torch.div(occ, C, rounding_mode='floor'), 1)
    phase = seed._hash_phase(torch.arange(n, device=occ.device), step)
    ci = torch.arange(C, dtype=torch.int32, device=occ.device)[None, :]
    # (ci * occ) // C without int32 overflow: occ = q*C + r
    q_ = torch.div(occ[:, None], C, rounding_mode='floor')
    r_ = torch.remainder(occ[:, None], C)
    big = ci * q_ + torch.div(ci * r_, C, rounding_mode='floor') \
        + phase[:, None]
    idx = starts[:, None] + torch.where(occ[:, None] > C, big, ci)
    gmax = max(positions.shape[0] - 1, 0)
    v = positions[torch.clamp_max(idx, gmax).long()]
    cols = torch.where(ci < use[:, None], v, 0)
    return torch.cat([occ[:, None], cols], dim=1)


def device_index(ref: Reference, sidx: SeedIndex, device: torch.device,
                 acfg: AlignConfig | None = None) -> list[DeviceIndex]:
    """Move the genome codes (uint8), the k-mer counts and positions
    (int32) to ``device`` and build the packed seed table there when the
    occurrence cap allows it (counterpart of _device_arrays and
    _device_table): one DeviceIndex for an unsharded index, one per shard
    (at least two) for a sharded one, each with its own cap.  Under an
    active mesh of several devices every tensor is also copied once to
    each other mesh device (``dispatch.replicas``), where the sharded
    calls read it; a device the mesh names twice holds one copy."""
    acfg = acfg or AlignConfig()
    parts = ([(sh.ref, sh.sidx, sh.contig_base) for sh in sidx.shards]
             if sidx.shards else [(ref, sidx, 0)])
    out = []
    for pref, psidx, base in parts:
        genome = torch.from_numpy(np.ascontiguousarray(pref.codes)).to(device)
        counts, positions = (
            torch.from_numpy(np.asarray(a, np.int32)).to(device)
            for a in (psidx.counts, psidx.positions))
        C = _occ_cap(psidx, acfg)
        table = (_build_table(counts, positions, C)
                 if C <= _MAX_TABLE_C and psidx.positions.size > 0 else None)
        out.append(DeviceIndex(genome, counts, positions, C, table, pref,
                               base))
        if dispatch.sharded():
            for t in (genome, counts, positions, table):
                dispatch.replicas(t)
    return out


# ---------------------------------------------------------------------------
# Seeding
# ---------------------------------------------------------------------------

def _query_rows(cat_d, sf, er, srev, qlens, SL: int):
    """(N, SL) query slices from the device read codes: forward rows
    cat[sf + j], reverse rows comp(cat[er - 1 - j]); pad 4 from qlens."""
    j = torch.arange(SL, device=cat_d.device)[None, :]
    last = max(cat_d.shape[0] - 1, 0)
    fwd = cat_d[(sf[:, None] + j).clamp(0, last)]
    rcs = cat_d[(er[:, None] - 1 - j).clamp(0, last)]
    rc = torch.where(rcs < 4, 3 - rcs, rcs)
    return torch.where(srev[:, None], rc, fwd).masked_fill(
        j >= qlens[:, None], 4)


def _seed_kernel(starts, lf, cat_d, counts, positions, table, L: int,
                 S: int, C: int, acfg: AlignConfig):
    """Candidate bands of both strands of the reads at ``starts`` (of
    lengths ``lf``) in ``cat_d``: (6, 2, nb, max_cand) int32, the keys of
    _SEED_KEYS, then forward and reverse (the batch on axis 2)."""
    nb = starts.shape[0]
    # forward rows, then reverse-complement rows, of every read
    starts, lf = starts.repeat(2), lf.repeat(2)
    lens2 = torch.clamp_max(lf, L).to(torch.int32)
    arr = _query_rows(cat_d, starts, starts + lf,
                      torch.arange(2 * nb, device=cat_d.device) >= nb,
                      lens2, L)
    res = seed.seed_candidates(
        arr, lens2, counts, positions, k=acfg.seed_k,
        stride=acfg.seed_stride, occ_drop=acfg.occ_drop,
        band_w=acfg.band_width // 2, max_cand=acfg.max_candidates, S=S,
        C=C, table=table)
    packed = torch.stack([res[n].to(torch.int32) for n in _SEED_KEYS])
    return packed.reshape(len(_SEED_KEYS), 2, nb, -1)


def _seed_rows(cat_d, off: np.ndarray, didx: DeviceIndex,
               config: PipelineConfig) -> Cands:
    """Seed both strands of every read; returns the candidate bands in
    the JAX package's order (per length bucket and batch: forward rows,
    then reverse-complement rows)."""
    acfg = config.align
    k = acfg.seed_k
    C = didx.occ_cap
    rlens = np.diff(off)
    buckets: dict[int, list[int]] = {}
    for i in range(len(rlens)):
        L = bucket_length(max(int(rlens[i]), k + 1),
                          config.batch.length_buckets)
        buckets.setdefault(L, []).append(i)
    pending = []          # (part, (6, 2, nb, max_cand) device tensor)
    for L, idxs in sorted(buckets.items()):
        S = max(1, (L - k) // acfg.seed_stride + 1)
        step = max(1, min(config.batch.batch_size, _SEED_HITS // (S * C)))
        for o in range(0, len(idxs), step):
            part = np.asarray(idxs[o:o + step], np.int64)
            starts, lf = (torch.from_numpy(a).to(cat_d.device)
                          for a in (off[part], rlens[part]))
            pending.append((part, dispatch.dp_call(
                _seed_kernel, (starts, lf),
                (cat_d, didx.counts, didx.positions, didx.table),
                statics=(L, S, C, acfg), out_dims=2)))
    if not pending:
        return _empty_cands()
    flat = torch.cat([p.reshape(-1) for (_, p) in pending]).cpu().numpy()
    cols = {n: [] for n in ('ridx', 'srev', 'dga', 'cnt', 'qmn', 'qmx',
                            'wcnt')}
    fo = 0
    for part, p in pending:
        nb = len(part)
        # forward rows, then reverse rows
        valid_a, count_a, diag_a, qmin_a, qmax_a, wsum_a = \
            flat[fo:fo + p.numel()].reshape(len(_SEED_KEYS), 2 * nb, -1)
        fo += p.numel()
        ok = ((valid_a != 0) & (count_a >= acfg.min_chain_seeds)
              & (qmax_a - qmin_a >= acfg.min_band_span))
        rr, cc = np.nonzero(ok)
        cols['ridx'].append(np.concatenate([part, part])[rr])
        cols['srev'].append(rr >= nb)
        for n, a in (('dga', diag_a), ('cnt', count_a), ('qmn', qmin_a),
                     ('qmx', qmax_a), ('wcnt', wsum_a)):
            cols[n].append(a[rr, cc].astype(np.int64))
    return Cands(*(np.concatenate(cols[n]) for n in cols))


def _merge_near_diagonal(cands: Cands, config: PipelineConfig) -> Cands:
    """Merge bands of the same (read, strand) whose diagonals sit close
    enough for one banded extension to bridge them (a sub-z-drop indel):
    greedy grouping over diagonal-sorted bands with adjacent diagonal gap
    and query gap <= 1.5 band half-widths; a group merges only when every
    member stays within band_w - 8 of the count-weighted mean diagonal.
    Merged bands take the summed counts and the union query span."""
    n = len(cands)
    if n <= 1:
        return cands
    band_w = config.align.band_width // 2
    gap_lim = band_w + band_w // 2
    dev_lim = band_w - 8
    ordr = np.lexsort((cands.dga, cands.srev, cands.ridx))
    s = cands.take(ordr)
    brk = np.ones(n, bool)
    qgap = (np.maximum(s.qmn[1:], s.qmn[:-1])
            - np.minimum(s.qmx[1:], s.qmx[:-1]))
    brk[1:] = ((s.ridx[1:] != s.ridx[:-1]) | (s.srev[1:] != s.srev[:-1])
               | (s.dga[1:] - s.dga[:-1] > gap_lim) | (qgap > gap_lim))
    gid = np.cumsum(brk) - 1
    ng = int(gid[-1]) + 1
    gcnt = np.bincount(gid, minlength=ng)
    if int(gcnt.max()) <= 1:
        return cands
    csum = np.bincount(gid, weights=s.cnt.astype(np.float64), minlength=ng)
    wsum = np.bincount(gid, weights=s.wcnt.astype(np.float64), minlength=ng)
    dmean = (np.bincount(gid, weights=(s.dga * s.cnt).astype(np.float64),
                         minlength=ng)
             / np.maximum(csum, 1)).astype(np.int64)
    dev_ok = np.ones(ng, bool)
    np.logical_and.at(dev_ok, gid, np.abs(s.dga - dmean[gid]) <= dev_lim)
    do_merge = (gcnt > 1) & dev_ok
    if not np.any(do_merge):
        return cands
    gmn = np.full(ng, np.int64(2 ** 62))
    np.minimum.at(gmn, gid, s.qmn)
    gmx = np.full(ng, -np.int64(2 ** 62))
    np.maximum.at(gmx, gid, s.qmx)
    # keep non-merging rows + the first row of each merging group, which
    # becomes the merged band in place
    idxs = np.flatnonzero((~do_merge[gid]) | brk)
    g_of = gid[idxs]
    rep = brk[idxs] & do_merge[g_of]
    return Cands(
        ridx=s.ridx[idxs], srev=s.srev[idxs],
        dga=np.where(rep, dmean[g_of], s.dga[idxs]),
        cnt=np.where(rep, csum[g_of].astype(np.int64), s.cnt[idxs]),
        qmn=np.where(rep, gmn[g_of], s.qmn[idxs]),
        qmx=np.where(rep, gmx[g_of], s.qmx[idxs]),
        wcnt=np.where(rep, wsum[g_of].astype(np.int64), s.wcnt[idxs]))


def _chain_filter(cands: Cands, rlens: np.ndarray,
                  config: PipelineConfig) -> np.ndarray:
    """bwa mem chain filtering (mem_chain_flt, -D 0.25): a read's bands in
    weight order; a band whose forward-read query span overlaps a kept
    band by >= mask_level of its own span, with weight below drop_ratio
    of that band's, is dropped.  Returns the kept rows' indices."""
    acfg = config.align
    mask_level = acfg.chain_mask_level
    drop_ratio = acfg.chain_drop_ratio
    n = len(cands)
    if drop_ratio <= 0 or n == 0:
        return np.arange(n)
    L = rlens[cands.ridx]
    lo_a = np.where(cands.srev, L - cands.qmx, cands.qmn)
    hi_a = np.where(cands.srev, L - cands.qmn, cands.qmx)
    ordr = np.lexsort((np.arange(n), -cands.wcnt, cands.ridx))
    rs = cands.ridx[ordr]
    gb = np.ones(n, bool)
    gb[1:] = rs[1:] != rs[:-1]
    gstart_pos = np.flatnonzero(gb)
    sizes = np.diff(np.concatenate([gstart_pos, [n]]))
    gs_rep = np.repeat(gstart_pos, sizes)     # group start per sorted row
    rank = np.arange(n) - gs_rep
    cnt_s = cands.wcnt[ordr]
    lo_s = lo_a[ordr]
    hi_s = hi_a[ordr]
    span_s = np.maximum(hi_s - lo_s, 1)
    keep_s = rank == 0                        # the heaviest band stays
    for r in range(1, int(rank.max()) + 1):
        cur = np.flatnonzero(rank == r)
        shadowed = np.zeros(len(cur), bool)
        for rp in range(r):
            prev = gs_rep[cur] + rp
            ov = (np.minimum(hi_s[cur], hi_s[prev])
                  - np.maximum(lo_s[cur], lo_s[prev]))
            shadowed |= (keep_s[prev]
                         & (ov >= mask_level * span_s[cur])
                         & (cnt_s[cur] < drop_ratio * cnt_s[prev]))
        keep_s[cur] = ~shadowed
    keep = np.zeros(n, bool)
    keep[ordr] = keep_s
    return np.flatnonzero(keep)


# ---------------------------------------------------------------------------
# Extension
# ---------------------------------------------------------------------------

def _rows_per_call(SL: int, device: torch.device) -> int:
    """Candidates per extension call: the call's gather temporaries (about
    32 bytes per window base) take at most an eighth of free memory."""
    free = (torch.cuda.mem_get_info(device)[0] if device.type == 'cuda'
            else 1 << 31)
    return max(128, free // 8 // (32 * (SL + 2 * banded.BW)))


def _score_kernel(sf, er, srev, qlens, ws, cmin, cmax, cat_d, genome,
                  SL: int, scoring):
    """Query slices gathered from ``cat_d``, then the score pass
    (banded.banded_extend_score): (5, N)."""
    q = _query_rows(cat_d, sf, er, srev, qlens, SL)
    return banded.banded_extend_score(q, qlens, ws, cmin, cmax, genome,
                                      scoring)


def _extend_rows(cands: Cands, cat_d, off: np.ndarray, didx: DeviceIndex,
                 config: PipelineConfig) -> CandAln:
    """Score pass over every band: the read slice [qmin - margin,
    qmax + margin) against its band window in ``didx``'s genome, forward
    then reversed.  Candidates keep the JAX package's order (slice
    bucket, then band); contigs are ``didx.ref``'s."""
    acfg = config.align
    ref = didx.ref
    n = len(cands)
    if n == 0:
        return _empty_cand_aln()
    dev = cat_d.device
    margin = acfg.extension_margin
    Lq = np.diff(off)[cands.ridx]
    qlo = np.maximum(0, cands.qmn - margin)
    qhi = np.minimum(Lq, cands.qmx + margin)
    sl_arr = np.asarray(_SLICE_BUCKETS, np.int64)
    sl_of = sl_arr[np.minimum(
        np.searchsorted(sl_arr, np.maximum(qhi - qlo, 1)), len(sl_arr) - 1)]
    ws_all = cands.dga + qlo - banded.BW // 2
    mid = cands.dga + (qlo + qhi) // 2
    ci_mid = np.clip(np.searchsorted(ref.offsets, mid, side='right') - 1,
                     0, len(ref.names) - 1)
    cmin_all = ref.offsets[:-1][ci_mid]
    cmax_all = ref.offsets[1:][ci_mid]

    pending = []      # (chunk index array, (5, N) device result)
    for SL in np.unique(sl_of):
        SL = int(SL)
        cidxs = np.flatnonzero(sl_of == SL)
        rows_per = _rows_per_call(SL, dev)
        for o in range(0, len(cidxs), rows_per):
            ci = cidxs[o:o + rows_per]
            ri = cands.ridx[ci]
            qlens = np.minimum(qhi[ci] - qlo[ci], SL)
            sf, er, srev, qlens, ws, cmin, cmax = (
                torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
                    off[ri] + qlo[ci], off[ri] + Lq[ci] - qlo[ci],
                    cands.srev[ci], qlens.astype(np.int32), ws_all[ci],
                    cmin_all[ci], cmax_all[ci]))
            pending.append((ci, dispatch.dp_call(
                _score_kernel, (sf, er, srev, qlens, ws, cmin, cmax),
                (cat_d, didx.genome), statics=(SL, acfg.scoring),
                out_dims=1)))

    flat = torch.cat([p.reshape(-1) for (_, p) in pending]).cpu().numpy()
    ck_all, res = [], []
    fo = 0
    for ci, p in pending:
        r = flat[fo:fo + p.numel()].reshape(5, len(ci))
        fo += p.numel()
        keep = r[0] > 0
        ck_all.append(ci[keep])
        res.append(r[:, keep].astype(np.int64))
    ck = np.concatenate(ck_all)
    score, qend, lane, qb, l_fin = np.concatenate(res, axis=1)
    rbegin = ws_all[ck] + qb + l_fin
    rend = ws_all[ck] + qend + lane
    ci_ref = np.clip(np.searchsorted(ref.offsets, rbegin, side='right') - 1,
                     0, len(ref.names) - 1)
    lo_c = ref.offsets[ci_ref]
    return CandAln(read_idx=cands.ridx[ck], strand_rev=cands.srev[ck],
                   chrom_idx=ci_ref.astype(np.int64), rstart=rbegin - lo_c,
                   rend=rend - lo_c, qstart_o=qlo[ck] + qb,
                   qend_o=qlo[ck] + qend + 1, qlen=Lq[ck], score=score,
                   ext_ws=ws_all[ck], ext_qlo=qlo[ck],
                   ext_qlen=np.minimum(qhi - qlo, sl_of)[ck]
                   .astype(np.int32),
                   ext_sl=sl_of[ck].astype(np.int32), ext_cmin=cmin_all[ck],
                   ext_cmax=cmax_all[ck], src=np.zeros(len(ck), np.int32),
                   genomes=[(didx.genome, ref.codes)])


# ---------------------------------------------------------------------------
# Selection, primary flags, MAPQ
# ---------------------------------------------------------------------------

def _build_regions(regions_path, names):
    """regions bed -> per-contig sorted (start, end) interval arrays."""
    per = {}
    if not regions_path:
        return per
    name_set = set(names)
    with open(regions_path) as fh:
        for line in fh:
            f = line.strip().split('\t')
            if len(f) < 3 or f[0] not in name_set:
                continue
            per.setdefault(f[0], []).append((int(f[1]), int(f[2])))
    return {k: np.array(sorted(v)) for k, v in per.items()}


def _overlaps_region(regions, chrom_name, start, end):
    """Closed-interval overlap of [start, end] with a contig's regions."""
    iv = regions.get(chrom_name)
    if iv is None or len(iv) == 0:
        return False
    return bool(np.any((iv[:, 0] < end) & (start < iv[:, 1])))


# bwa-mem mapQ model constants (mem_approx_mapq_se defaults)
_MAPQ_COEF_LEN = 50
_MAPQ_COEF_FAC = float(np.log(_MAPQ_COEF_LEN))


def _bwa_style_mapq(s1, s2, span, rspan, sub_n, match_a: int,
                    mismatch_b: int, sub_floor: int):
    """Vectorized bwa-mem single-end MAPQ: score gap to the best
    overlapping sub-optimal hit (floored at sub_floor), damped by squared
    identity and alignment length, minus a log penalty for the number of
    such hits; clamped to [0, 60]."""
    s1 = s1.astype(np.float64)
    sub = np.maximum(s2, sub_floor).astype(np.float64)
    l = np.maximum(np.maximum(span, rspan), 1)
    identity = 1.0 - (l * match_a - s1) / ((match_a + mismatch_b) * l)
    tmp = np.where(l < _MAPQ_COEF_LEN, 1.0,
                   _MAPQ_COEF_FAC / np.log(np.maximum(l, 2)))
    tmp = tmp * identity * identity
    mq = (6.02 * (s1 - sub) / match_a * tmp * tmp + 0.499).astype(np.int64)
    pen = (4.343 * np.log(sub_n + 1) + 0.499).astype(np.int64)
    mq = np.where(sub_n > 0, mq - pen, mq)
    mq = np.where((s1 <= 0) | (sub >= s1), 0, mq)
    return np.clip(mq, 0, 60)


def _select_and_finalize(ca: CandAln, ref: Reference,
                         config: PipelineConfig, regions_path: str | None,
                         cat: np.ndarray, off: np.ndarray, cat_d,
                         timer=None) -> Alignments:
    """Dedup, selection, walk-derived begins and CIGARs (exact_cigars),
    primary flags, MAPQ, then the z-drop split -- fslr_tpu's order."""
    acfg = config.align
    device = cat_d.device
    regions = _build_regions(regions_path, ref.names)
    if len(ca) == 0:
        return empty_alignments()

    # dedup identical alignments (keep the first occurrence, in order)
    packed = np.stack([getattr(ca, c).astype(np.int64) for c in (
        'read_idx', 'strand_rev', 'chrom_idx', 'rstart', 'rend',
        'qstart_o', 'qend_o')], axis=1)
    _, first = np.unique(packed, axis=0, return_index=True)
    ca = ca.take(np.sort(first))
    n = len(ca)

    # candidate slot = rank within the read in encounter order; slots >= C
    # are left out of selection but count as sub-optimal hits for MAPQ
    reads = np.unique(ca.read_idx)
    b = np.searchsorted(reads, ca.read_idx)
    B = len(reads)
    cnts = np.bincount(b, minlength=B)
    C = min(64, max(int(cnts.max()), 1))
    gstart = np.zeros(B + 1, np.int64)
    np.cumsum(cnts, out=gstart[1:])
    cslot = np.empty(n, np.int64)
    cslot[np.argsort(b, kind='stable')] = (np.arange(n)
                                           - np.repeat(gstart[:-1], cnts))
    val = cslot < C

    # query coordinates on the FORWARD read
    fs = np.where(ca.strand_rev, ca.qlen - ca.qend_o, ca.qstart_o)
    fe = np.where(ca.strand_rev, ca.qlen - ca.qstart_o, ca.qend_o)

    # region overlap (closed intervals, pd.Interval semantics)
    ov_any = np.zeros(n, bool)
    name_idx = {nm: i for i, nm in enumerate(ref.names)}
    for cname, iv in regions.items():
        m = np.flatnonzero(ca.chrom_idx == name_idx[cname])
        s_ = ca.rstart[m] + 1
        e_ = ca.rend[m] + 1
        acc = np.zeros(len(m), bool)
        for a0, b0 in iv:
            acc |= (a0 < e_) & (s_ < b0)
        ov_any[m] = acc

    qs = np.zeros((B, C), np.int32)
    qe = np.zeros((B, C), np.int32)
    sc = np.zeros((B, C), np.float32)
    bias = np.ones((B, C), np.float32)
    vmask = np.zeros((B, C), bool)
    bb, cc = b[val], cslot[val]
    qs[bb, cc] = fs[val]
    qe[bb, cc] = fe[val]
    sc[bb, cc] = ca.score[val]
    vmask[bb, cc] = True
    if regions:
        bias[bb, cc] = np.where(ov_any[val], np.float32(acfg.bias),
                                np.float32(1.0))
    qs, qe, sc, vmask, bias = (torch.from_numpy(a).to(device)
                               for a in (qs, qe, sc, vmask, bias))
    chosen = dispatch.dp_call(
        _select_kernel, (qs, qe, sc, vmask, bias),
        statics=(acfg.ol_cost, acfg.max_overlap,
                 acfg.min_selected_score)).cpu().numpy()
    sel_mask = np.zeros(n, bool)
    sel_mask[val] = chosen[bb, cc]
    sel_idx = np.flatnonzero(sel_mask)
    n_sel = len(sel_idx)
    if config.exact_cigars:
        with timer.stage('align_emit') if timer else contextlib.nullcontext():
            cig_rle, (qs_walk, rs_walk) = _emit_selected(
                ca, sel_idx, cat_d, off, config)
        # walk-derived begins replace the reverse-pass ones, so that
        # records and their CIGARs describe the same co-optimal path
        ca.qstart_o[sel_idx] = qs_walk
        ca.rstart[sel_idx] = rs_walk
    else:
        cig_rle = _no_emits(n_sel)

    out = Alignments(
        read_idx=ca.read_idx[sel_idx].astype(np.int32),
        chrom_idx=ca.chrom_idx[sel_idx].astype(np.int32),
        rstart=ca.rstart[sel_idx].astype(np.int32),
        rend=ca.rend[sel_idx].astype(np.int32),
        strand_rev=ca.strand_rev[sel_idx],
        qstart_o=ca.qstart_o[sel_idx].astype(np.int32),
        qend_o=ca.qend_o[sel_idx].astype(np.int32),
        qlen=ca.qlen[sel_idx].astype(np.int32),
        score=ca.score[sel_idx].astype(np.int32),
        mapq=np.zeros(n_sel, np.int32),
        is_primary=np.zeros(n_sel, bool),
        overlaps_region=ov_any[sel_idx],
        cig_rle=cig_rle,
    )
    if not n_sel:
        return out
    _mark_primary(out)

    # MAPQ: s2 = best unselected candidate of the read whose forward query
    # span overlaps the selected one by > 50%
    fs_sel = fs[sel_idx].astype(np.int64)
    fe_sel = fe[sel_idx].astype(np.int64)
    span = fe_sel - fs_sel
    s2 = np.zeros(n_sel, np.int64)
    sub_n = np.zeros(n_sel, np.int64)
    uns = np.flatnonzero(~sel_mask)
    if len(uns):
        uo = np.argsort(ca.read_idx[uns], kind='stable')
        u_read, u_fs, u_fe, u_sc = (a[uns][uo] for a in (
            ca.read_idx, fs, fe, ca.score))
        lo = np.searchsorted(u_read, out.read_idx)
        hi = np.searchsorted(u_read, out.read_idx, side='right')
        counts = hi - lo
        total = int(counts.sum())
        if total:
            sel_rep = np.repeat(np.arange(n_sel), counts)
            offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
            u_idx = np.arange(total) - np.repeat(offs - lo, counts)
            ov = (np.minimum(fe_sel[sel_rep], u_fe[u_idx])
                  - np.maximum(fs_sel[sel_rep], u_fs[u_idx]))
            ok = ov > 0.5 * span[sel_rep]
            np.maximum.at(s2, sel_rep[ok], u_sc[u_idx[ok]])
            sub_n = np.bincount(sel_rep[ok], minlength=n_sel)
    match_a = acfg.scoring.match
    out.mapq[:] = _bwa_style_mapq(
        out.score, s2, span, (out.rend - out.rstart + 1).astype(np.int64),
        sub_n, match_a, abs(acfg.scoring.mismatch), acfg.seed_k * match_a)
    return _zdrop_split_rows(out, ca, sel_idx, regions, ref, config, cat, off)


def _select_kernel(qs, qe, sc, vmask, bias, ol_cost, max_overlap,
                   min_score):
    """selection.select_alignments with positional settings (dp_call's
    statics)."""
    return selection.select_alignments(
        qs, qe, sc, vmask, ol_cost=ol_cost, max_overlap=max_overlap,
        bias=bias, min_score=min_score)


def _emit_kernel(sf, er, srev, qlens, ws, cmin, cmax, cat_d, genome,
                 SL: int, scoring):
    """Query slices gathered from ``cat_d``, then the traceback extension
    (traceback.banded_extend): ((6, N) packed, (N, (SL + 128) / 4)
    emits)."""
    q = _query_rows(cat_d, sf, er, srev, qlens, SL)
    return traceback.banded_extend(q, qlens, ws, cmin, cmax, genome, scoring)


def _no_emits(n: int):
    return (np.zeros(n, bool), np.zeros(n, np.int64),
            np.zeros(0, np.int64), np.zeros(0, np.int64))


def _emit_selected(ca: CandAln, sel_idx: np.ndarray, cat_d, off: np.ndarray,
                   config: PipelineConfig):
    """Traceback extension over the selected candidates only
    (fslr_tpu.stages.align._emit_selected): rows grouped by source genome
    and slice bucket and chunked so that a call's codes take about
    _EMIT_BITS bytes; all results come back in two transfers.

    Returns (cig_rle, (qstart_o, rstart)): the columnar RLE (has, cnt,
    flat_len, flat_op) in selected order, op codes 0/1/2 = M/I/D, and the
    walk-derived begins (contig-local to ext_cmin)."""
    n = len(sel_idx)
    if not n:
        return _no_emits(0), (np.zeros(0, np.int64), np.zeros(0, np.int64))
    dev = cat_d.device
    sl = ca.ext_sl[sel_idx].astype(np.int64)
    keys = (ca.src[sel_idx].astype(np.int64) << 32) | sl
    ri = ca.read_idx[sel_idx]
    qlo = ca.ext_qlo[sel_idx]
    ws = ca.ext_ws[sel_idx]
    cmin = ca.ext_cmin[sel_idx]
    rows = (off[ri] + qlo, off[ri] + ca.qlen[sel_idx] - qlo,
            ca.strand_rev[sel_idx], ca.ext_qlen[sel_idx].astype(np.int32),
            ws, cmin, ca.ext_cmax[sel_idx])
    pending = []          # (selected rows, (6, n) packed, emits)
    for key in np.unique(keys).tolist():
        genome = ca.genomes[key >> 32][0]
        SL = key & 0xffffffff
        gall = np.flatnonzero(keys == key)
        rows_per = max(1, _EMIT_BITS // (SL * 64))
        for o in range(0, len(gall), rows_per):
            g = gall[o:o + rows_per]
            sf, er, srev, qlens, ws_g, cmin_g, cmax_g = (
                torch.from_numpy(np.ascontiguousarray(a[g])).to(dev)
                for a in rows)
            pending.append((g, *dispatch.dp_call(
                _emit_kernel, (sf, er, srev, qlens, ws_g, cmin_g, cmax_g),
                (cat_d, genome), statics=(SL, config.align.scoring),
                out_dims=(1, 0))))
    allp = torch.cat([p.reshape(-1) for _, p, _ in pending]).cpu().numpy()
    alle = torch.cat([e.reshape(-1) for _, _, e in pending]).cpu().numpy()
    qs_walk = np.zeros(n, np.int64)
    lf_walk = np.zeros(n, np.int64)
    seg_rows_l, seg_len_l, seg_op_l = [], [], []
    po = eo = 0
    for g, p, e in pending:
        p_np = allp[po:po + p.numel()].reshape(tuple(p.shape))
        e_np = alle[eo:eo + e.numel()].reshape(tuple(e.shape))
        po += p.numel()
        eo += e.numel()
        _, _, _, qs_walk[g], lf_walk[g] = traceback.finalize_scores(p_np)
        sr, sl_, so_ = traceback.decode_emit_rle(e_np)
        seg_rows_l.append(g[sr])
        seg_len_l.append(sl_)
        seg_op_l.append(so_)
    seg_rows = np.concatenate(seg_rows_l)
    # groups leave rows unordered across groups; a stable sort by row
    # restores selected order and keeps each row's op order
    ordr = np.argsort(seg_rows, kind='stable')
    cnt = np.bincount(seg_rows, minlength=n).astype(np.int64)
    cig_rle = (np.ones(n, bool), cnt,
               np.concatenate(seg_len_l).astype(np.int64)[ordr],
               np.concatenate(seg_op_l)[ordr])
    return cig_rle, (qlo + qs_walk, ws + qs_walk + lf_walk - cmin)


def _zdrop_split_rows(out: Alignments, ca: CandAln, sel_idx: np.ndarray,
                      regions, ref: Reference, config: PipelineConfig,
                      cat: np.ndarray, off: np.ndarray) -> Alignments:
    """bwa z-drop equivalent (fslr_tpu.stages.align._zdrop_split_rows):
    a selected alignment with an interior indel run whose affine penalty
    exceeds ``zdrop`` is cut at those runs; each piece's score is
    replayed on the host from the query and source genome codes (+match /
    mismatch, N = mismatch, a gap run g costs open + ext*g), pieces below
    the dodi floor are dropped, edge indel runs of a piece are trimmed,
    and primary flags are re-derived.  MAPQ is inherited from the fused
    parent; split rows keep their place, other rows are untouched."""
    acfg = config.align
    zdrop = acfg.zdrop
    if not zdrop or not len(out):
        return out
    has, cnt, flat_len, flat_op = out.cig_rle
    if not np.any(has):
        return out
    sc = acfg.scoring
    gap_open = abs(sc.gap_open)
    gap_ext = abs(sc.gap_extend)
    # smallest interior gap with penalty open + ext*g > zdrop
    g_split = (zdrop - gap_open) // gap_ext + 1
    ends = np.cumsum(cnt)
    starts = ends - cnt
    n_rows = len(out)
    seg_row = np.repeat(np.arange(n_rows), cnt)
    big = (flat_len >= g_split) & (flat_op != 0)
    if not np.any(big):
        return out
    src_sel = ca.src[sel_idx]
    cmin_sel = ca.ext_cmin[sel_idx]
    keep_seg = np.ones(len(flat_len), bool)
    pieces_per_row = np.ones(n_rows, np.int64)
    row_pieces: dict[int, list] = {}
    for r in np.unique(seg_row[big]).tolist():
        sl = flat_len[starts[r]:ends[r]]
        so = flat_op[starts[r]:ends[r]]
        n_seg = len(sl)
        bounds = np.flatnonzero((sl >= g_split) & (so != 0))
        # record-orientation query codes for the replay
        o = off[int(out.read_idx[r])]
        L = int(out.qlen[r])
        qrec = (_COMP[cat[o:o + L]][::-1] if out.strand_rev[r]
                else cat[o:o + L])
        ref_codes = ca.genomes[src_sel[r]][1]
        rabs0 = int(cmin_sel[r] + out.rstart[r])
        qoff = np.zeros(n_seg + 1, np.int64)
        roff = np.zeros(n_seg + 1, np.int64)
        np.cumsum(np.where(so != 2, sl, 0), out=qoff[1:])   # M, I
        np.cumsum(np.where(so != 1, sl, 0), out=roff[1:])   # M, D
        q0 = int(out.qstart_o[r])
        lo = 0
        plist = []
        for b in np.append(bounds, n_seg).tolist():
            # segments [lo, b); trim edge indels (a local alignment never
            # starts or ends in a gap)
            while lo < b and so[lo] != 0:
                lo += 1
            hi = b
            while hi > lo and so[hi - 1] != 0:
                hi -= 1
            if hi > lo:
                score = 0
                for t in range(lo, hi):
                    ln = int(sl[t])
                    if so[t] == 0:
                        a = qrec[q0 + int(qoff[t]):q0 + int(qoff[t]) + ln]
                        bref = ref_codes[rabs0 + int(roff[t]):
                                         rabs0 + int(roff[t]) + ln]
                        m = int(np.sum((a == bref) & (a < 4) & (bref < 4)))
                        score += m * sc.match + (ln - m) * sc.mismatch
                    else:
                        score -= gap_open + gap_ext * ln
                if score >= acfg.min_selected_score:
                    plist.append(dict(
                        lo=lo, hi=hi, qs=q0 + int(qoff[lo]),
                        qe=q0 + int(qoff[hi]),
                        rs=int(out.rstart[r]) + int(roff[lo]),
                        re=int(out.rstart[r]) + int(roff[hi]),
                        score=score))
            lo = b + 1
        seg_keep = np.zeros(n_seg, bool)
        for p in plist:
            seg_keep[p['lo']:p['hi']] = True
        keep_seg[starts[r]:ends[r]] = seg_keep
        pieces_per_row[r] = len(plist)
        row_pieces[r] = plist

    rep = np.repeat(np.arange(n_rows), pieces_per_row)
    new = Alignments(
        read_idx=out.read_idx[rep], chrom_idx=out.chrom_idx[rep],
        rstart=out.rstart[rep], rend=out.rend[rep],
        strand_rev=out.strand_rev[rep], qstart_o=out.qstart_o[rep],
        qend_o=out.qend_o[rep], qlen=out.qlen[rep], score=out.score[rep],
        mapq=out.mapq[rep], is_primary=np.zeros(len(rep), bool),
        overlaps_region=out.overlaps_region[rep])
    pos_of = np.concatenate([[0], np.cumsum(pieces_per_row)])[:-1]
    new_cnt = np.zeros(len(rep), np.int64)
    new_has = np.zeros(len(rep), bool)
    # a surviving row's first slot keeps its cnt/has; split rows
    # overwrite all their slots below
    kept = pieces_per_row >= 1
    new_cnt[pos_of[kept]] = cnt[kept]
    new_has[pos_of[kept]] = has[kept]
    for r, plist in row_pieces.items():
        for k, p in enumerate(plist):
            i = pos_of[r] + k
            new.qstart_o[i] = p['qs']
            new.qend_o[i] = p['qe']
            new.rstart[i] = p['rs']
            new.rend[i] = p['re'] - 1            # rend is inclusive
            new.score[i] = p['score']
            new_cnt[i] = p['hi'] - p['lo']
            new_has[i] = True
            if regions:
                new.overlaps_region[i] = _overlaps_region(
                    regions, ref.names[int(new.chrom_idx[i])],
                    p['rs'] + 1, p['re'])
    new.cig_rle = (new_has, new_cnt, flat_len[keep_seg], flat_op[keep_seg])
    _mark_primary(new)
    return new


def _mark_primary(out: Alignments):
    """Primary = the first max-score alignment of each read."""
    n = len(out)
    ordr = np.lexsort((np.arange(n), -out.score, out.read_idx))
    rid_s = out.read_idx[ordr]
    first_m = np.ones(n, bool)
    first_m[1:] = rid_s[1:] != rid_s[:-1]
    out.is_primary[ordr[first_m]] = True


def _gather_candidates(cat_d, off: np.ndarray, didx: list[DeviceIndex],
                       config: PipelineConfig) -> CandAln:
    """Seed + extend: candidate alignments against one reference, in its
    contig numbering (fslr_tpu.stages.align._gather_candidates)."""
    if len(didx) > 1:
        return _gather_candidates_sharded(cat_d, off, didx, config)
    (d,) = didx
    cands = _seed_rows(cat_d, off, d, config)
    cands = _merge_near_diagonal(cands, config)
    cands = cands.take(_chain_filter(cands, np.diff(off), config))
    return _extend_rows(cands, cat_d, off, d, config)


def _gather_candidates_sharded(cat_d, off: np.ndarray,
                               shards: list[DeviceIndex],
                               config: PipelineConfig) -> CandAln:
    """Seed every shard, keep the per-(read, strand) budget an unsharded
    index would have (the max_candidates heaviest bands, stable ties),
    merge near-diagonal bands within each shard, filter chains across all
    shards, then extend per shard and renumber its contigs
    (fslr_tpu.stages.align._gather_candidates_sharded)."""
    parts = [_seed_rows(cat_d, off, d, config) for d in shards]
    cands = Cands.concat(parts)
    sid = np.repeat(np.arange(len(parts)), [len(p) for p in parts])
    n = len(cands)
    if n == 0:
        return _empty_cand_aln()
    ordr = np.lexsort((np.arange(n), -cands.wcnt, cands.srev, cands.ridx))
    key = cands.ridx[ordr] * 2 + cands.srev[ordr]
    new_grp = np.ones(n, bool)
    new_grp[1:] = key[1:] != key[:-1]
    gstart = np.flatnonzero(new_grp)
    rank = np.arange(n) - np.repeat(gstart, np.diff(np.append(gstart, n)))
    keep = np.zeros(n, bool)
    keep[ordr] = rank < config.align.max_candidates
    cands, sid = cands.take(np.flatnonzero(keep)), sid[keep]
    # a merged band's window must lie in one shard's genome
    merged = [_merge_near_diagonal(cands.take(np.flatnonzero(sid == si)),
                                   config) for si in np.unique(sid)]
    sid = np.repeat(np.unique(sid), [len(m) for m in merged])
    cands = Cands.concat(merged)
    kept = _chain_filter(cands, np.diff(off), config)
    cands, sid = cands.take(kept), sid[kept]
    out = []
    for si, d in enumerate(shards):
        rows = np.flatnonzero(sid == si)
        if len(rows):
            a = _extend_rows(cands.take(rows), cat_d, off, d, config)
            a.chrom_idx = a.chrom_idx + d.contig_base
            out.append(a)
    return CandAln.concat(out)


def align_batch(seqs: list[str], ref: Reference, didx: list[DeviceIndex],
                config: PipelineConfig, regions_path: str | None = None,
                masked: tuple[Reference, list[DeviceIndex]] | None = None,
                codes: tuple[np.ndarray, np.ndarray] | None = None,
                timer=None) -> Alignments:
    """Align a list of read sequences against the device-resident index
    (``device_index``; one entry per shard); returns the selected
    alignments.  ``masked``: the masked reference and its device index;
    its candidates, on contigs that ``ref`` also names, are pooled with
    the reference's before selection, as fslr_tpu pools them.
    ``codes``: the reads as (concatenated 0-4 codes, offsets), when the
    caller already holds them.  ``timer`` (a StageTimer) gets the
    traceback emit's time as ``align_emit``."""
    if codes is None:
        from fslr_tpu_torch.encode import encode_cat
        codes = encode_cat(seqs)
    cat, off = codes
    cat_d = torch.from_numpy(np.ascontiguousarray(cat)).to(
        didx[0].genome.device)
    ca = _gather_candidates(cat_d, off, didx, config)
    if masked is not None:
        mref, mdidx = masked
        name_to_idx = {n: i for i, n in enumerate(ref.names)}
        mca = _gather_candidates(cat_d, off, mdidx, config)
        remap = np.array([name_to_idx.get(n, -1) for n in mref.names],
                         np.int64)
        new_ci = remap[mca.chrom_idx]
        mca = mca.take(np.flatnonzero(new_ci >= 0))
        mca.chrom_idx = new_ci[new_ci >= 0]
        ca = CandAln.concat([ca, mca])
    return _select_and_finalize(ca, ref, config, regions_path, cat, off,
                                cat_d, timer)
