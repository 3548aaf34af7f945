"""Batched Smith-Waterman: sw_max, sw_locate and the lane-packed scan.

Counterpart of ``fslr_tpu/ops/ssw.py``.  Query columns j (<= 128) are the
DP lanes, target positions i are scanned.  The affine in-row dependency
(lazy F) is the closed form

    F[i][j] = cummax_{k<=j-1}(Hno[i][k] + k*e) - fg - (j-1)*e

over Hno, H without F.  Every value is an integer below 2^24 held in
float32, so the plain version here, the CUDA kernels (``csrc/ssw.cu``) and
the JAX package agree exactly.

Each public function runs the plain PyTorch version for CPU tensors and
launches the CUDA kernel for CUDA tensors.

End semantics (ssw library): per-lane running maxima with strict ">" keep
the first target row at each column's maximum; the query end is the
smallest column at the global maximum and the target end the smallest
best-row over all columns at it; a score <= 0 reports both ends as 0.
"""

from __future__ import annotations

import numpy as np
import torch

from fslr_tpu_torch import kernels
from fslr_tpu_torch.config import ScoringConfig

NEG = -1e30
QP = 128          # query lanes
SEG_BIG = 1.0e6   # segment offset of the packed kernel's prefix-max


def first_gap_cost(sc: ScoringConfig) -> float:
    return float(sc.gap_open if sc.gap_open_is_first_base
                 else sc.gap_open + sc.gap_extend)


def _scores(sc: ScoringConfig) -> dict:
    return dict(match=float(sc.match), mismatch=float(sc.mismatch),
                fg=first_gap_cost(sc), ext=float(sc.gap_extend))


# ---------------------------------------------------------------------------
# DP primitives of the plain versions (shared with ops/banded.py)
# ---------------------------------------------------------------------------

def _shift_right(x, d: int, fill: float):
    """x[:, j] -> x[:, j-d]; columns j < d take ``fill``."""
    out = torch.full_like(x, fill)
    out[:, d:] = x[:, :-d]
    return out


def _shift_left(x):
    """x[:, l] -> x[:, l+1]; the last column takes NEG (outside the band)."""
    out = torch.full_like(x, NEG)
    out[:, :-1] = x[:, 1:]
    return out


def _cummax_exclusive(x):
    """max over k <= j-1 of x[:, k]; NEG at j == 0."""
    return torch.cummax(_shift_right(x, 1, NEG), dim=1).values


def _sw_step(H, E, bestH, bestI, s, i, keep, jidx, fg, ext,
             segoff=None, seg_start=None):
    """One target row (fslr_tpu.ops.ssw._sw_step, and _sw_step_packed when
    ``segoff``/``seg_start`` are given).  ``keep`` masks best updates."""
    E = torch.maximum(E - ext, H - fg)
    diag = _shift_right(H, 1, 0.0)
    if seg_start is not None:
        diag = diag.masked_fill(seg_start, 0.0)
    Hno = torch.clamp_min(torch.maximum(diag + s, E), 0.0)
    x = Hno + jidx * ext
    if segoff is not None:
        x = x + segoff
    Cm = _cummax_exclusive(x)
    if segoff is not None:
        Cm = Cm - segoff
    F = Cm - fg - (jidx - 1.0) * ext
    H = torch.maximum(Hno, F)
    upd = (H > bestH) & keep
    bestH = torch.where(upd, H, bestH)
    bestI = bestI.masked_fill(upd, float(i))
    return H, E, bestH, bestI


def _finalize(bestH, bestI, keep, jidx):
    """Reduce per-lane maxima to (score, target_end, query_end)."""
    bh = bestH.masked_fill(~keep, NEG)
    score = bh.max(dim=1).values
    is_best = bh == score[:, None]
    qend = jidx.masked_fill(~is_best, 1e9).min(dim=1).values
    tend = bestI.masked_fill(~is_best, 1e9).min(dim=1).values
    score = torch.clamp_min(score, 0.0)
    none = score <= 0.0
    return (score, tend.masked_fill(none, 0.0).to(torch.int32),
            qend.masked_fill(none, 0.0).to(torch.int32))


def _init_state(B, device):
    zeros = torch.zeros((B, QP), dtype=torch.float32, device=device)
    neg = torch.full((B, QP), NEG, dtype=torch.float32, device=device)
    return zeros, neg, neg.clone(), zeros.clone()


def _n_steps(lens, T: int) -> int:
    """Target rows that can change any row's maxima."""
    return min(T, int(lens.max())) if lens.numel() else 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _sw_torch(q, t, qlens, tlens, *, match, mismatch, fg, ext):
    """Plain version of sw_kernel (fslr_tpu.ops.ssw._sw_jax)."""
    B, T = t.shape
    jidx = torch.arange(QP, dtype=torch.float32,
                        device=t.device).expand(B, QP)
    qmask = jidx < qlens[:, None].float()
    q = q.long()
    subs_valid = q < 4
    H, E, bestH, bestI = _init_state(B, t.device)
    for i in range(_n_steps(tlens, T)):
        tcol = t[:, i:i + 1].long()
        eq = (q == tcol) & subs_valid & (tcol < 4)
        s = torch.where(eq, match, mismatch).masked_fill(~qmask, NEG)
        keep = qmask & (i < tlens)[:, None]
        H, E, bestH, bestI = _sw_step(H, E, bestH, bestI, s, i, keep, jidx,
                                      fg, ext)
    return _finalize(bestH, bestI, qmask, jidx)


def _sw_packed_torch(q, t, tlens, *, match, mismatch, fg, ext, stride):
    """Plain version of sw_packed_kernel (fslr_tpu.ops.ssw._sw_packed_jax)."""
    B, T = t.shape
    jidx = torch.arange(QP, dtype=torch.float32,
                        device=t.device).expand(B, QP)
    segoff = torch.floor(jidx / float(stride)) * SEG_BIG
    seg_start = torch.remainder(jidx, float(stride)) == 0.0
    q = q.long()
    lane_valid = q < 4
    H, E, bestH, bestI = _init_state(B, t.device)
    for i in range(_n_steps(tlens, T)):
        tcol = t[:, i:i + 1].long()
        eq = (q == tcol) & lane_valid & (tcol < 4)
        s = torch.where(eq, match, mismatch).masked_fill(~lane_valid, NEG)
        keep = lane_valid & (i < tlens)[:, None]
        H, E, bestH, bestI = _sw_step(H, E, bestH, bestI, s, i, keep, jidx,
                                      fg, ext, segoff, seg_start)
    return _finalize(bestH, bestI, lane_valid, jidx)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _check_queries(q, B, dev):
    kernels.check(q, 'q', torch.uint8, (B, QP), dev)
    if q.data_ptr() % 4:
        raise ValueError('q: rows are read as 32-bit words; the data '
                         'pointer must be 4-byte aligned')


def _sw_cuda(q, t, qlens, tlens, *, match, mismatch, fg, ext):
    B, T = t.shape
    dev = t.device
    _check_queries(q, B, dev)
    kernels.check(t, 't', torch.uint8, (B, T), dev)
    kernels.check(qlens, 'qlens', torch.int32, (B,), dev)
    kernels.check(tlens, 'tlens', torch.int32, (B,), dev)
    score = torch.empty(B, dtype=torch.float32, device=dev)
    tend = torch.empty(B, dtype=torch.int32, device=dev)
    qend = torch.empty(B, dtype=torch.int32, device=dev)
    kernels.SW.launch(q.data_ptr(), t.data_ptr(), qlens.data_ptr(),
                      tlens.data_ptr(), B, T, match, mismatch, fg, ext,
                      score.data_ptr(), tend.data_ptr(), qend.data_ptr())
    return score, tend, qend


def _sw_packed_cuda(q, t, tlens, *, match, mismatch, fg, ext, stride):
    B, T = t.shape
    dev = t.device
    _check_queries(q, B, dev)
    kernels.check(t, 't', torch.uint8, (B, T), dev)
    kernels.check(tlens, 'tlens', torch.int32, (B,), dev)
    score = torch.empty(B, dtype=torch.float32, device=dev)
    tend = torch.empty(B, dtype=torch.int32, device=dev)
    lane = torch.empty(B, dtype=torch.int32, device=dev)
    kernels.SW_PACKED.launch(q.data_ptr(), t.data_ptr(), tlens.data_ptr(),
                             B, T, stride, match, mismatch, fg, ext,
                             score.data_ptr(), tend.data_ptr(),
                             lane.data_ptr())
    return score, tend, lane


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _pad_queries(queries):
    q = queries.to(torch.uint8)
    if q.shape[1] < QP:
        q = torch.nn.functional.pad(q, (0, QP - q.shape[1]), value=4)
    return q.contiguous()


def sw_max(queries, targets, qlens, tlens, scoring: ScoringConfig):
    """Best local alignment of queries[b] vs targets[b] for every row.

    Args: queries (B, <=128) uint8 codes padded with 4; targets (B, T)
    uint8; qlens, tlens (B,) int32 -- all on one device.
    Returns (score f32, target_end i32, query_end i32), each (B,), ends
    0-based inclusive; score-0 rows report ends of 0.
    """
    q = _pad_queries(queries)
    t = targets.to(torch.uint8).contiguous()
    qlens = qlens.to(torch.int32).contiguous()
    tlens = tlens.to(torch.int32).contiguous()
    fn = _sw_cuda if kernels.on_card(t) else _sw_torch
    return fn(q, t, qlens, tlens, **_scores(scoring))


def _reverse_prefix(x, ends):
    """out[b, i] = x[b, ends[b] - i] for i <= ends[b], else 4."""
    L = x.shape[1]
    idx = ends[:, None].long() - torch.arange(L, device=x.device)[None, :]
    out = torch.gather(x, 1, idx.clamp(0, L - 1))
    return out.masked_fill(idx < 0, 4)


def sw_locate(queries, targets, qlens, tlens, scoring: ScoringConfig):
    """Like :func:`sw_max`, plus begins recovered ssw-style: a second pass
    aligns the reversed prefixes ending at the optimum (begin = end -
    reverse end).  Returns a dict of (B,) tensors: score, target_begin,
    target_end, query_begin, query_end."""
    q = queries.to(torch.uint8)
    t = targets.to(torch.uint8)
    score, tend, qend = sw_max(q, t, qlens, tlens, scoring)
    rq = _reverse_prefix(q, qend)
    rt = _reverse_prefix(t, tend)
    _, rtend, rqend = sw_max(rq, rt, qend + 1, tend + 1, scoring)
    none = score <= 0.0
    zero = torch.zeros_like(tend)
    return {
        'score': score,
        'target_begin': torch.where(none, zero, tend - rtend),
        'target_end': tend,
        'query_begin': torch.where(none, zero, qend - rqend),
        'query_end': qend,
    }


def pack_queries(code_lists, stride: int):
    """Pack short query code arrays into (n_rows, 128) at ``stride`` lane
    offsets.  Returns (rows uint8, row_of, lane_seg_of) where
    row_of[i]/lane_seg_of[i] locate query i."""
    per_row = QP // stride
    n_rows = (len(code_lists) + per_row - 1) // per_row
    rows = np.full((max(n_rows, 1), QP), 4, np.uint8)
    row_of = np.zeros(len(code_lists), np.int32)
    seg_of = np.zeros(len(code_lists), np.int32)
    for i, c in enumerate(code_lists):
        if len(c) > stride:
            raise ValueError(f'query {i} longer than stride {stride}')
        r, g = divmod(i, per_row)
        rows[r, g * stride:g * stride + len(c)] = c
        row_of[i] = r
        seg_of[i] = g
    return rows, row_of, seg_of


def sw_max_packed(queries, targets, tlens, scoring: ScoringConfig,
                  stride: int):
    """Row-global best score over all packed queries vs targets[b].
    ``queries`` (B, 128) uint8 with one query per ``stride``-lane segment
    (pad 4).  Returns (score, target_end, lane_of_best)."""
    q = _pad_queries(queries)
    t = targets.to(torch.uint8).contiguous()
    tlens = tlens.to(torch.int32).contiguous()
    fn = _sw_packed_cuda if kernels.on_card(t) else _sw_packed_torch
    return fn(q, t, tlens, stride=stride, **_scores(scoring))
