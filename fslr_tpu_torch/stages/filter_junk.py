"""Stage A: junk / concatemer filtering on an explicit device.

Counterpart of ``fslr_tpu/stages/filter_junk.py``, with the same
decisions, counters and output file:

* junk       -- a repeat-masked block > 150 bp that is non-telomeric and
                repetitive (ops/tantan.repeat_mask, ops/kmer_stats);
* short      -- len < 200, or no interior after the 100 bp end trims;
* concatemer -- any primer (forward or reverse complement) aligns with SW
                score >= 28 inside the interior, scanned in 10 kb windows
                with a primer-length + 10 overlap; all primers lane-pack
                into one query row (ops/ssw.sw_max_packed).

Survivors go to ``{out}/{name}.{uuid}.filtered_junk.fq`` as repeat-masked
FASTA records (repeats lowercase).  Batches are cut to bound device
memory only; rows are independent, so no batch is padded.  The mask and
gate, the rep score and the concatemer scan go through
``parallel.dispatch.dp_call`` (row shards over the active mesh).
"""

from __future__ import annotations

import os
import uuid
from collections import Counter

import numpy as np
import torch

from fslr_tpu_torch import instrument
from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.encode import bucket_length, encode, revcomp
from fslr_tpu_torch.io.fastq import read_reads, records_to_arrays
from fslr_tpu_torch.ops import kmer_stats, ssw, tantan
from fslr_tpu_torch.panel import PrimerPanel
from fslr_tpu_torch.parallel import dispatch

_HMM_ROWS_X_LEN = 1 << 21      # rows x length per repeat-mask batch
_WINDOW_CHUNK = 8192           # concatemer windows per SW call


def _batch_rows(reads, part, L: int):
    """Padded (len(part), L) uint8 batch + lengths for read indices
    ``part``, filled with one contiguous copy per row."""
    part_arr = np.asarray(part, np.int64)
    nb = len(part_arr)
    off = reads.seq_off
    batch = np.full((nb, L), 4, dtype=np.uint8)
    lw = np.minimum(off[part_arr + 1] - off[part_arr], L).astype(np.int64)
    starts = off[part_arr].tolist()
    lw_l = lw.tolist()
    for r in range(nb):
        batch[r, :lw_l[r]] = reads.codes[starts[r]:starts[r] + lw_l[r]]
    return batch, lw.astype(np.int32)


def _concatemer_windows(length: int, cfg, overlap: int):
    """Window (start, end) pairs in interior coordinates: the reference
    chunk walk (filter_junk_from_fq.py:79-99)."""
    interior = length - 2 * cfg.end_trim
    if interior <= 0:
        return []
    if interior <= cfg.chunk_size:
        return [(0, interior)]
    out = []
    start = 0
    while start < interior:
        s = max(0, start - overlap)
        e = min(start + cfg.chunk_size + overlap, interior)
        out.append((s, e))
        if start + cfg.chunk_size >= interior:
            break
        start += cfg.chunk_size
    return out


def _pack_mask(m):
    """Bit-pack a (N, L) bool mask to (N, ceil(L/8)) uint8 on its device
    (little-endian bit order, as np.unpackbits(bitorder='little'))."""
    N, L = m.shape
    L8 = (L + 7) // 8 * 8
    m = torch.nn.functional.pad(m, (0, L8 - L)).to(torch.uint8)
    w = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                     device=m.device)
    return (m.reshape(N, L8 // 8, 8) * w).sum(dim=2, dtype=torch.uint8)


def _mask_gate_packed(seq, lens, cfg):
    """Bit-packed repeat mask and junk gate of one batch (one function,
    so that a mesh shards them as one call)."""
    m = tantan.repeat_mask(seq, lens, cfg)
    return _pack_mask(m), kmer_stats.junk_gates(seq, lens, m, cfg)


def _upload(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def filter_junk_records(reads, panel: PrimerPanel, config: PipelineConfig,
                        device: torch.device):
    """Classify reads (a FastxArrays, or a list of FastxRecord).  Returns
    (keep, flat_mask, junk, short, concat, counters); ``flat_mask`` is a
    uint8 repeat mask aligned with ``reads.codes`` (1 = masked)."""
    if isinstance(reads, list):
        reads = records_to_arrays(reads)
    cfg = config.junk
    counters = Counter(total_kept=0, total_dropped=0, junk_seqs_dropped=0,
                       short_seqs_dropped=0, concatemers_dropped=0)
    n = reads.n
    rlens = reads.lengths()
    junk = np.zeros(n, dtype=bool)
    flat_mask = np.zeros(len(reads.codes), np.uint8)
    soff = reads.seq_off

    # ---- pass 1: repeat mask + junk gate, bucketed by length -----------
    buckets: dict[int, list[int]] = {}
    for i in range(n):
        L = bucket_length(int(rlens[i]), config.batch.length_buckets)
        buckets.setdefault(L, []).append(i)
    pending = []       # (part, L, packed mask, gate) on the device
    for L, idxs in sorted(buckets.items()):
        step = max(1, min(config.batch.batch_size, _HMM_ROWS_X_LEN // L))
        for off in range(0, len(idxs), step):
            part = idxs[off:off + step]
            seq, lens = _upload(device, *_batch_rows(reads, part, L))
            pending.append((part, L, *dispatch.dp_call(
                _mask_gate_packed, (seq, lens), statics=(cfg,))))
            instrument.add_cells(2 * 100 * len(part) * L, 'hmm')
    gate = np.zeros(n, dtype=bool)
    if pending:
        flat_m = torch.cat([mp.reshape(-1) for (_, _, mp, _) in pending]) \
            .cpu().numpy()
        flat_g = torch.cat([g for (_, _, _, g) in pending]).cpu().numpy()
        mo = go = 0
        for part, L, mp, _ in pending:
            msz = mp.numel()
            m = np.unpackbits(flat_m[mo:mo + msz].reshape(tuple(mp.shape)),
                              axis=1, bitorder='little')[:, :L]
            mo += msz
            part_arr = np.asarray(part, np.int64)
            gate[part_arr] = flat_g[go:go + len(part)]
            go += len(part)
            lw = np.minimum(rlens[part_arr], L).tolist()
            starts = soff[part_arr].tolist()
            for r in range(len(part_arr)):
                flat_mask[starts[r]:starts[r] + lw[r]] = m[r, :lw[r]]

    # ---- pass 2: rep score for gated reads only ------------------------
    gated = np.flatnonzero(gate)
    if gated.size:
        gbuckets: dict[int, list[int]] = {}
        for i in gated:
            L = bucket_length(int(rlens[i]), config.batch.length_buckets)
            gbuckets.setdefault(L, []).append(int(i))
        rep_pending = []
        for L, idxs in sorted(gbuckets.items()):
            cap = max(1, min(config.batch.batch_size, _HMM_ROWS_X_LEN // L))
            for off in range(0, len(idxs), cap):
                part = idxs[off:off + cap]
                seq, lens = _batch_rows(reads, part, L)
                m = np.zeros((len(part), L), dtype=bool)
                lw = np.minimum(rlens[part], L).tolist()
                starts = soff[part].tolist()
                for r in range(len(part)):
                    m[r, :lw[r]] = flat_mask[starts[r]:starts[r] + lw[r]]
                seq, lens, m = _upload(device, seq, lens, m)
                rep_pending.append((part, dispatch.dp_call(
                    kmer_stats.junk_blocks, (seq, lens, m), statics=(cfg,))))
        flat_j = torch.cat([j for (_, j) in rep_pending]).cpu().numpy()
        junk[np.concatenate([p for (p, _) in rep_pending])] = flat_j

    # ---- short / concatemer for non-junk reads -------------------------
    primers = [panel.seqs[k] for k in panel.names]
    prim_codes = ([encode(p) for p in primers]
                  + [revcomp(encode(p)) for p in primers])
    maxp = max((len(p) for p in primers), default=0)
    overlap = maxp + cfg.chunk_overlap_pad
    stride = 32
    while stride < maxp:
        stride *= 2
    qrows = (ssw.pack_queries(prim_codes, stride)[0] if prim_codes
             else np.zeros((0, 128), np.uint8))
    n_qrows = len(qrows)

    interior = rlens.astype(np.int64) - 2 * cfg.end_trim
    short = ~junk & ((rlens < cfg.min_read_length) | (interior <= 0))
    cand = np.flatnonzero(~junk & ~short)
    simple = cand[interior[cand] <= cfg.chunk_size]
    multi = cand[interior[cand] > cfg.chunk_size]
    wr_i = [np.repeat(simple, n_qrows)]
    wr_s = [np.zeros(len(simple) * n_qrows, np.int64)]
    wr_e = [np.repeat(interior[simple], n_qrows)]
    wr_q = [np.tile(np.arange(n_qrows, dtype=np.int64), len(simple))]
    for i in multi:
        for (s, e) in _concatemer_windows(int(rlens[i]), cfg, overlap):
            wr_i.append(np.full(n_qrows, i, np.int64))
            wr_s.append(np.full(n_qrows, s, np.int64))
            wr_e.append(np.full(n_qrows, e, np.int64))
            wr_q.append(np.arange(n_qrows, dtype=np.int64))
    wr_i, wr_s, wr_e, wr_q = map(np.concatenate, (wr_i, wr_s, wr_e, wr_q))

    concat = np.zeros(n, dtype=bool)
    if len(wr_i):
        WT = int(np.max(wr_e - wr_s))
        scores = []
        for off in range(0, len(wr_i), _WINDOW_CHUNK):
            sl = slice(off, off + _WINDOW_CHUNK)
            # interior window [end_trim+s, end_trim+e) of each read
            we = np.minimum(wr_e[sl], rlens[wr_i[sl]] - 2 * cfg.end_trim)
            wl = np.maximum(we - wr_s[sl], 0)
            start = soff[wr_i[sl]] + cfg.end_trim + wr_s[sl]
            t = np.full((len(wl), WT), 4, dtype=np.uint8)
            st_l, wl_l = start.tolist(), wl.tolist()
            for r in range(len(wl)):
                t[r, :wl_l[r]] = reads.codes[st_l[r]:st_l[r] + wl_l[r]]
            q, t, tlens = _upload(device, qrows[wr_q[sl]], t,
                                  wl.astype(np.int32))
            scores.append(dispatch.dp_call(
                ssw.sw_max_packed, (q, t, tlens),
                statics=(config.scoring, stride))[0])
            instrument.add_cells(int(wl.sum()) * 128, 'sw_concat')
        flat_s = torch.cat(scores).cpu().numpy()
        concat[wr_i[flat_s >= cfg.concatemer_score]] = True

    # ---- decisions + counters (reference order: junk, short, concat) ---
    keep = ~(junk | short | concat)
    counters['junk_seqs_dropped'] = int(junk.sum())
    counters['short_seqs_dropped'] = int((~junk & short).sum())
    counters['concatemers_dropped'] = int((~junk & ~short & concat).sum())
    counters['total_kept'] = int(keep.sum())
    counters['total_dropped'] = n - int(keep.sum())
    return keep, flat_mask, junk, short, concat, counters


def run_file(path: str, panel: PrimerPanel, config: PipelineConfig,
             device: torch.device, out_box: dict | None = None) -> dict:
    """Filter one input file; returns its counters.  Writes
    ``{out}/{name}.{uuid}.filtered_junk.fq`` (+ ``.junk.fq`` with
    keep_temp).  ``out_box`` receives {'path', 'reads'} so the primer
    stage can take the kept, masked reads without re-parsing the file."""
    from fslr_tpu_torch.io.native import _DECODE, FastxArrays

    reads = read_reads(path)
    keep, flat_mask, junk, short, concat, counters = filter_junk_records(
        reads, panel, config, device)
    temp_name = str(uuid.uuid4())
    out_path = os.path.join(config.out,
                            f'{config.name}.{temp_name}.filtered_junk.fq')
    junk_path = os.path.join(config.out, f'{config.name}.{temp_name}.junk.fq')
    # FASTA records, repeats lowercase (ASCII | 0x20 where masked)
    raw = _DECODE[reads.codes]
    if flat_mask.any():
        raw = raw | (flat_mask.astype(np.uint8) << 5)
    seq_buf = raw.tobytes()
    soff = reads.seq_off.tolist()
    noff = reads.name_off.tolist()
    coff = reads.comment_off.tolist()
    names_b, comm_b = reads._names, reads._comments
    kept_idx = []
    parts: list[bytes] = []
    jparts: list[bytes] = []
    junk_l, short_l = junk.tolist(), short.tolist()
    for i, kp in enumerate(keep.tolist()):
        head = names_b[noff[i]:noff[i + 1]]
        if not kp:
            if not config.keep_temp:
                continue
            head += (b'_junk' if junk_l[i]
                     else b'_short' if short_l[i] else b'_concatemer')
        c = comm_b[coff[i]:coff[i + 1]]
        if c:
            head = head + b' ' + c
        rec = b'>' + head + b'\n' + seq_buf[soff[i]:soff[i + 1]] + b'\n'
        if kp:
            parts.append(rec)
            kept_idx.append(i)
        else:
            jparts.append(rec)
    with open(out_path, 'wb') as out:
        out.write(b''.join(parts))
    if config.keep_temp:
        with open(junk_path, 'wb') as junkf:
            junkf.write(b''.join(jparts))
    if out_box is not None:
        if len(kept_idx) == reads.n:
            kept = FastxArrays(
                reads.n, reads.codes, flat_mask.astype(np.uint8),
                reads.seq_off, reads._names, reads.name_off,
                b'', reads.qual_off, reads._comments, reads.comment_off)
        else:
            so = reads.seq_off
            kept = reads.subset(
                kept_idx, lower_override=[flat_mask[so[i]:so[i + 1]]
                                          for i in kept_idx])
            kept._quals = b''   # the handoff mirrors the FASTA file
        out_box['path'] = out_path
        out_box['reads'] = kept
    return dict(counters)
