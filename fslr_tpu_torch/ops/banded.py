"""Banded affine Smith-Waterman: the align score pass.

Counterpart of ``fslr_tpu/ops/banded.py``.  Band offsets l = 0..127 are
the DP lanes, query positions i are scanned, and cell (i, l) covers window
base i + l (reference position ws + i + l).  Predecessors: diagonal = same
lane; query gap = lane l+1 of the previous row; reference gap = lane l-1
of the same row (the lazy-F prefix-max of ops/ssw.py).

``banded_sw`` runs the plain version for CPU tensors and the CUDA kernel
(``csrc/banded.cu``) for CUDA tensors; ``banded_extend_score`` adds the
window gathers and the reversed second pass that recovers begins.
"""

from __future__ import annotations

import torch

from fslr_tpu_torch import kernels
from fslr_tpu_torch.config import ScoringConfig
from fslr_tpu_torch.ops.ssw import (QP, _cummax_exclusive, _init_state,
                                    _int_scores, _scores, _shift_left)

BW = QP           # band width (lanes)


def _banded_step(H, E, bestH, bestI, s, i, qmask_i, lidx, fg, ext):
    """One query row (fslr_tpu.ops.banded._banded_step)."""
    E = torch.maximum(_shift_left(E) - ext, _shift_left(H) - fg)
    Hno = torch.clamp_min(torch.maximum(H + s, E), 0.0)
    F = _cummax_exclusive(Hno + lidx * ext) - fg - (lidx - 1.0) * ext
    H = torch.maximum(Hno, F)
    upd = (H > bestH) & qmask_i
    return H, E, torch.where(upd, H, bestH), bestI.masked_fill(upd, float(i))


def _banded_torch(q, w, qlens, *, match, mismatch, fg, ext):
    """Plain version of banded_kernel (fslr_tpu.ops.banded._banded_jax)."""
    N, Lq = q.shape
    dev = q.device
    lidx = torch.arange(BW, dtype=torch.float32, device=dev).expand(N, BW)
    q = q.long()
    w = w.long()
    H, E, bestH, bestI = _init_state(N, dev)
    n = min(Lq, int(qlens.max())) if N else 0
    for i in range(n):
        qcol = q[:, i:i + 1]
        wsl = w[:, i:i + BW]
        eq = (wsl == qcol) & (qcol < 4) & (wsl < 4)
        s = torch.where(eq, match, mismatch)
        H, E, bestH, bestI = _banded_step(H, E, bestH, bestI, s, i,
                                          (i < qlens)[:, None], lidx, fg,
                                          ext)
    score = bestH.max(dim=1).values
    is_best = bestH == score[:, None]
    lane = lidx.masked_fill(~is_best, 1e9).min(dim=1).values
    qend = bestI.masked_fill(~is_best, 1e9).min(dim=1).values
    score = torch.clamp_min(score, 0.0)
    none = score <= 0.0
    return (score, qend.masked_fill(none, 0.0).to(torch.int32),
            lane.masked_fill(none, 0.0).to(torch.int32))


LAYOUTS = (8, 16)   # band columns per CUDA lane: narrow, wide
WIDE_ROWS_PER_SM = 32


def _layout(N: int, dev, layouts) -> int:
    """Band columns per CUDA lane (128 / cols lanes a row, cols / 4 rows a
    warp) for a launch of N rows: the wide layout (16, the fewest
    instructions a cell) from WIDE_ROWS_PER_SM rows an SM, where issue
    decides, else the narrow one (shorter steps, so the longest rows end
    sooner).  The threshold lies between the widest main-path launch the
    narrow layout won and the narrowest the wide one won
    (chip_smoke.sweep_layouts, PERF.md)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return layouts[1] if N >= WIDE_ROWS_PER_SM * sms else layouts[0]


def _row_order(qlens):
    """Rows by descending query length (stable) as int32: the rows sharing
    a warp end together, and the longest start first."""
    return torch.argsort(qlens, descending=True, stable=True).to(torch.int32)


def _banded_cuda(q, w, qlens, *, match, mismatch, fg, ext, cpl=None):
    N, Lq = q.shape
    dev = q.device
    kernels.check(q, 'q', torch.uint8, (N, Lq), dev)
    kernels.check(w, 'w', torch.uint8, (N, Lq + 2 * BW), dev)
    kernels.check(qlens, 'qlens', torch.int32, (N,), dev)
    sc = _int_scores(match, mismatch, fg, ext)
    cpl = cpl or _layout(N, dev, LAYOUTS)
    order = _row_order(qlens)
    score = torch.empty(N, dtype=torch.float32, device=dev)
    qend = torch.empty(N, dtype=torch.int32, device=dev)
    lane = torch.empty(N, dtype=torch.int32, device=dev)
    kernels.BANDED.launch(q, w, qlens, order, N, Lq, *sc, score, qend, lane,
                          cpl)
    return score, qend, lane


def banded_sw(q, w, qlens, scoring: ScoringConfig):
    """Best banded local alignment per row.  q (N, Lq) uint8 codes, w
    (N, Lq + 256) window codes, qlens (N,) int32.  Returns (score, qend,
    lane), ends 0-based inclusive."""
    q = q.to(torch.uint8).contiguous()
    w = w.to(torch.uint8).contiguous()
    qlens = qlens.to(torch.int32).contiguous()
    if w.shape[1] != q.shape[1] + 2 * BW:
        raise ValueError(f'window width {w.shape[1]} != Lq + {2 * BW}')
    fn = _banded_cuda if kernels.on_card(q) else _banded_torch
    return fn(q, w, qlens, **_scores(scoring))


def _genome_windows(genome, start, step: int, WL: int, cmin, cmax):
    """(N, WL) codes genome[start + step * t], pad 4 outside the contig
    [cmin, cmax) and the genome."""
    idx = start[:, None].long() + step * torch.arange(
        WL, dtype=torch.long, device=genome.device)[None, :]
    valid = ((idx >= cmin[:, None]) & (idx < cmax[:, None]) & (idx >= 0)
             & (idx < genome.shape[0]))
    return genome[idx.clamp(0, max(genome.shape[0] - 1, 0))] \
        .masked_fill(~valid, 4)


def banded_extend_score(q, qlens, ws, cmin, cmax, genome,
                        scoring: ScoringConfig):
    """Score-only extension of every row against its genome window.

    Args: q (N, SL) uint8 read-slice codes; qlens (N,) int32; ws/cmin/cmax
    (N,) window starts and contig bounds (global genome coordinates);
    genome (G,) uint8 codes, on the device of q.
    Returns a (5, N) int32 tensor [score, qend, lane, qstart, l_fin]: ends
    and begins 0-based inclusive, rbegin = ws + qstart + l_fin and
    rend = ws + qend + lane.

    The reverse pass reads the reversed query from qend down and the
    reversed window from rstart0 = ws + qend + BW - 1 down, so forward
    cell (i, l) maps to reverse cell (qend - i, BW-1 - l): its best end
    (jend, lane_r) gives qstart = qend - jend and l_fin = BW-1 - lane_r.
    """
    SL = q.shape[1]
    WL = SL + 2 * BW
    ws = ws.long()
    w = _genome_windows(genome, ws, 1, WL, cmin, cmax)
    score, qend, lane = banded_sw(q, w, qlens, scoring)

    qidx = qend[:, None].long() - torch.arange(SL, device=q.device)[None, :]
    qr = torch.gather(q, 1, qidx.clamp(0, SL - 1)).masked_fill(qidx < 0, 4)
    wr = _genome_windows(genome, ws + qend.long() + (BW - 1), -1, WL, cmin,
                         cmax)
    _, jend, lane_r = banded_sw(qr, wr, qend + 1, scoring)
    return torch.stack([score.to(torch.int32), qend, lane, qend - jend,
                        (BW - 1) - lane_r])
