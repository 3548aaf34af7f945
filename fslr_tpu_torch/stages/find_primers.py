"""Stage B: primer identification + trimming on an explicit device.

Counterpart of ``fslr_tpu/stages/find_primers.py``, with the same labels,
trims, record names, output files and counters: every distinct (primer
target, orientation) is aligned (ops/ssw.sw_locate) against the first
and the last min(len/2, 500) bp of every read, and the |P|^2 * 4 pair
scores are combined on the host.  Ties between equal pair sums take the
last pair in panel order, orientation combos [(F,R), (R,F), (F,F), (R,R)].
The SW calls go through ``parallel.dispatch.dp_call`` (row shards over
the active mesh).
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch

from fslr_tpu_torch import instrument
from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.encode import encode, revcomp
from fslr_tpu_torch.io.fastq import (FastxRecord, read_reads,
                                     records_to_arrays)
from fslr_tpu_torch.ops import ssw
from fslr_tpu_torch.panel import PrimerPanel
from fslr_tpu_torch.parallel import dispatch

ORIENT_COMBOS = (('F', 'R'), ('R', 'F'), ('F', 'F'), ('R', 'R'))
_SW_KEYS = ('score', 'target_begin', 'target_end')
_SW_CHUNK = 8192          # alignments per sw_locate call


def _align_side(reads, targets, window, scoring, side: str, device):
    """sw_locate of every primer target against one window side of every
    read.  Returns a (3, n * m) float32 device tensor (rows: _SW_KEYS),
    alignment r = read r // m against target r % m."""
    n = reads.n
    m = len(targets)
    cat = reads.codes
    off = reads.seq_off
    L = np.diff(off).astype(np.int64)
    space = np.minimum(L // 2, window)
    ar = np.arange(512, dtype=np.int64)
    start = off[:-1] if side == 'start' else off[1:] - space
    pos = start[:, None] + ar[None, :]
    wv = cat[np.minimum(pos, max(len(cat) - 1, 0))] if len(cat) else \
        np.full((n, 512), 4, np.uint8)
    win = np.where(ar[None, :] < space[:, None], wv, 4).astype(np.uint8)
    qmat = np.full((m, 128), 4, dtype=np.uint8)
    qlen1 = np.zeros(m, np.int32)
    for j, tc in enumerate(targets):
        qmat[j, :len(tc)] = tc
        qlen1[j] = len(tc)
    t_all = torch.from_numpy(np.repeat(win, m, axis=0)).to(device)
    tl_all = torch.from_numpy(np.repeat(space.astype(np.int32), m)).to(device)
    q_all = torch.from_numpy(np.tile(qmat, (n, 1))).to(device)
    ql_all = torch.from_numpy(np.tile(qlen1, n)).to(device)
    outs = []
    for o in range(0, n * m, _SW_CHUNK):
        sl = slice(o, o + _SW_CHUNK)
        res = dispatch.dp_call(
            ssw.sw_locate, (q_all[sl], t_all[sl], ql_all[sl], tl_all[sl]),
            statics=(scoring,))
        outs.append(torch.stack([res[k].float() for k in _SW_KEYS]))
    instrument.add_cells(int(np.tile(qlen1, n).astype(np.int64)
                             @ np.repeat(space, m)), 'sw_primer')
    return torch.cat(outs, dim=1)


_DEC_TABLE = np.frombuffer(b'ACGTN', dtype=np.uint8)


def _to_str(codes: np.ndarray, lower: np.ndarray | None) -> str:
    raw = _DEC_TABLE[codes]
    if lower is not None and len(lower) and lower.any():
        raw = raw | (lower[:len(raw)].astype(np.uint8) << 5)
    return raw.tobytes().decode('ascii')


def label_and_chop(reads, panel: PrimerPanel, config: PipelineConfig,
                   device: torch.device):
    """Returns (labelled_records, has_primer_flags, counters) for a
    FastxArrays (or a list of FastxRecord)."""
    if isinstance(reads, list):
        reads = records_to_arrays(reads)
    cfg = config.primer
    names = list(panel.names)
    tdefs = []          # distinct (name, strand, codes), F then R per name
    for k in names:
        tc = encode(panel.targets[k])
        tdefs.append((k, 'F', tc))
        tdefs.append((k, 'R', revcomp(tc)))
    tcodes = [c for (_, _, c) in tdefs]
    tlen = np.array([len(c) for c in tcodes])

    counters = Counter()
    counters['starting_bases'] = 0
    counters['trimmed_bases'] = 0
    counters['trimmed_reads'] = 0
    if reads.n == 0:
        return [], np.zeros(0, bool), counters

    m = len(tcodes)
    sides = [_align_side(reads, tcodes, cfg.search_window, config.scoring,
                         side, device) for side in ('start', 'end')]
    flat = torch.stack(sides).cpu().numpy()          # ONE device fetch
    a1, a2 = ({k: flat[s, i].reshape(reads.n, m)
               for i, k in enumerate(_SW_KEYS)} for s in (0, 1))

    pair_defs = []      # (t1_idx, t2_idx, k1, k2, s1, s2)
    for i1, k1 in enumerate(names):
        for i2, k2 in enumerate(names):
            for (s1, s2) in ORIENT_COMBOS:
                t1 = 2 * i1 + (0 if s1 == 'F' else 1)
                t2 = 2 * i2 + (0 if s2 == 'F' else 1)
                pair_defs.append((t1, t2, k1, k2, s1, s2))
    p1_idx = np.array([p[0] for p in pair_defs])
    p2_idx = np.array([p[1] for p in pair_defs])

    # normalized scores (float64, the reference's host arithmetic)
    max_score = (2.0 * tlen).astype(np.float64)
    s1 = a1['score'].astype(np.float64)[:, p1_idx] / max_score[p1_idx]
    s2 = a2['score'].astype(np.float64)[:, p2_idx] / max_score[p2_idx]
    sums = np.round(s1, 2) + np.round(s2, 2)
    best = sums.shape[1] - 1 - np.argmax(sums[:, ::-1], axis=1)  # last max

    nR = reads.n
    ai = np.arange(nR)
    t1 = p1_idx[best]
    t2 = p2_idx[best]
    sc1 = a1['score'].astype(np.float64)[ai, t1] / max_score[t1]
    sc2 = a2['score'].astype(np.float64)[ai, t2] / max_score[t2]
    f1 = sc1 < cfg.trim_threshold
    f2 = sc2 < cfg.trim_threshold
    L_all = np.diff(reads.seq_off).astype(np.int64)
    p2_space = np.minimum(L_all // 2, cfg.search_window)
    tb = a1['target_begin'][ai, t1].astype(np.int64)
    te = L_all - p2_space + a2['target_end'][ai, t2].astype(np.int64)
    no_primer = f1 & f2
    tb_eff = np.where(no_primer, 0, tb)
    te_eff = np.where(no_primer, L_all, te)
    trimmed = tb_eff + (L_all - te_eff)
    counters['starting_bases'] = int(L_all.sum())
    counters['trimmed_bases'] = int(trimmed.sum())
    counters['trimmed_reads'] = int((trimmed > 0).sum())
    lab1 = np.array([k1 + st1 for (_, _, k1, _, st1, _) in pair_defs],
                    object)[best]
    lab2 = np.array([k2 + st2 for (_, _, _, k2, _, st2) in pair_defs],
                    object)[best]
    lab1[f1] = 'False'
    lab2[f2] = 'False'
    r1_all = np.round(sc1, 2)
    r2_all = np.round(sc2, 2)
    combos, combo_counts = np.unique(
        np.array([f'{x}_{y}' for x, y in zip(lab1, lab2)], object),
        return_counts=True)
    for cb, ct in zip(combos, combo_counts):
        counters[str(cb)] += int(ct)

    out_records = []
    for i in range(nR):
        codes = reads.seq_codes(i)[tb_eff[i]:te_eff[i]]
        lower = reads.lower_mask(i)[tb_eff[i]:te_eff[i]]
        qual = reads.qual(i)
        if qual and not no_primer[i]:
            qual = qual[tb_eff[i]:te_eff[i]]
        new_name = (f'{reads.name(i)}.{r1_all[i]}_{r2_all[i]}.'
                    f'{lab1[i]}_{lab2[i]}')
        out_records.append(FastxRecord(name=new_name,
                                       sequence=_to_str(codes, lower),
                                       quality=qual,
                                       comment=reads.comment(i)))
    return out_records, ~no_primer, counters


def run_file(path: str, panel: PrimerPanel, config: PipelineConfig,
             device: torch.device, records=None) -> dict:
    """Process one ``.filtered_junk.fq`` file, writing
    ``{basename}.primers_labelled.fq`` and ``{basename}.no_primers.fq``.
    ``records`` (a FastxArrays or a record list) skips re-parsing when the
    caller already holds the file's reads."""
    if 'filtered_junk' in path:
        basename = path.replace('.filtered_junk.fq', '')
    else:
        basename = path.replace('.fa', '')
    if records is None:
        records = read_reads(path)
    out_records, has_primer, counters = label_and_chop(
        records, panel, config, device)
    with open(f'{basename}.primers_labelled.fq', 'w') as out, \
         open(f'{basename}.no_primers.fq', 'w') as out2:
        for rec, hp in zip(out_records, has_primer):
            (out if hp else out2).write(str(rec) + '\n')
    if 'filtered_junk' in path and not config.keep_temp:
        os.remove(path)
    return dict(counters)
