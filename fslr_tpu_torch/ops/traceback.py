"""Banded SW with traceback codes, the path walk, and the emit decoders.

Counterpart of ``fslr_tpu/ops/traceback.py``.  The banded DP of
ops/banded.py also writes each cell's 4-bit code:

  bits 0-1  H source: 0 = local start, 1 = diagonal, 2 = E (query gap /
            insertion), 3 = F (reference gap / deletion)
  bit 2     E extends a previous E (vs opening from H)
  bit 3     F extends a previous F (vs opening from H)

8 consecutive query steps share one int32 word (code << 4*(i % 8)), giving
a (N, Lq/8, 128) tensor.  The walk follows every alignment back from its
end cell and emits one op per step (end -> start), 2-bit packed.  On a
CUDA tensor ``banded_sw_tb`` launches ``tb_kernel`` (csrc/banded.cu) and
``walk`` launches ``walk_kernel`` (csrc/traceback.cu); on a CPU tensor the
plain versions here run.  Source ties prefer F (strictly above the
no-F value), then the diagonal, then E.

The host decoders at the bottom are copied from the JAX module, which
imports jax.  The consensus engines decode walks with them too.
"""

from __future__ import annotations

import numpy as np
import torch

from fslr_tpu_torch import kernels
from fslr_tpu_torch.config import ScoringConfig
from fslr_tpu_torch.ops.banded import BW, _genome_windows
from fslr_tpu_torch.ops.ssw import (NEG, _cummax_exclusive, _init_state,
                                    _scores, _shift_left, _shift_right)

# op codes emitted by the walk
OP_M, OP_I, OP_D = 0, 1, 2
_OP_CHARS = 'MID'
_NONE = 255          # no emit at this step (3 once 2-bit packed)


def _tb_step(H, E, s, lidx, fg, ext):
    """One query row (fslr_tpu.ops.traceback._tb_step); returns (H, E,
    code) with code (N, BW) int32."""
    H_up = _shift_left(H)
    E_up = _shift_left(E)
    e_ext = (E_up - ext) >= (H_up - fg)
    E = torch.maximum(E_up - ext, H_up - fg)
    diag = H + s
    Hno = torch.clamp_min(torch.maximum(diag, E), 0.0)
    C = Hno + lidx * ext
    Cm = _cummax_exclusive(C)
    F = Cm - fg - (lidx - 1.0) * ext
    # F opened at lane l-1 iff the prefix max is achieved by C[l-1]
    f_ext = Cm > _shift_right(C, 1, NEG)
    pos = Hno > 0.0
    src = torch.where(F > Hno, 3,
                      torch.where((diag == Hno) & pos, 1,
                                  torch.where((E == Hno) & pos, 2, 0)))
    code = (src + e_ext.int() * 4 + f_ext.int() * 8).to(torch.int32)
    return torch.maximum(Hno, F), E, code


def _tb_torch(q, w, qlens, *, match, mismatch, fg, ext):
    """Plain version of tb_kernel (fslr_tpu.ops.traceback._tb_jax): every
    one of the Lq query steps, codes OR-ed into their words as they come."""
    N, Lq = q.shape
    dev = q.device
    lidx = torch.arange(BW, dtype=torch.float32, device=dev).expand(N, BW)
    q = q.long()
    w = w.long()
    H, E, bestH, bestI = _init_state(N, dev)
    bits = torch.zeros((N, Lq // 8, BW), dtype=torch.int32, device=dev)
    for i in range(Lq):
        qcol = q[:, i:i + 1]
        wsl = w[:, i:i + BW]
        eq = (wsl == qcol) & (qcol < 4) & (wsl < 4)
        s = torch.where(eq, match, mismatch)
        H, E, code = _tb_step(H, E, s, lidx, fg, ext)
        upd = (H > bestH) & (i < qlens)[:, None]
        bestH = torch.where(upd, H, bestH)
        bestI = bestI.masked_fill(upd, float(i))
        bits[:, i >> 3] |= code << (4 * (i & 7))
    score = bestH.max(dim=1).values
    is_best = bestH == score[:, None]
    lane = lidx.masked_fill(~is_best, 1e9).min(dim=1).values
    qend = bestI.masked_fill(~is_best, 1e9).min(dim=1).values
    score = torch.clamp_min(score, 0.0)
    none = score <= 0.0
    return (score, qend.masked_fill(none, 0.0).to(torch.int32),
            lane.masked_fill(none, 0.0).to(torch.int32), bits)


def _check_rows(q, w, qlens):
    N, Lq = q.shape
    if Lq % 16:
        raise ValueError(f'query width {Lq} is not a multiple of 16')
    kernels.check(q, 'q', torch.uint8, (N, Lq), q.device)
    kernels.check(w, 'w', torch.uint8, (N, Lq + 2 * BW), q.device)
    kernels.check(qlens, 'qlens', torch.int32, (N,), q.device)


def _tb_cuda(q, w, qlens, *, match, mismatch, fg, ext):
    N, Lq = q.shape
    dev = q.device
    _check_rows(q, w, qlens)
    score = torch.empty(N, dtype=torch.float32, device=dev)
    qend = torch.empty(N, dtype=torch.int32, device=dev)
    lane = torch.empty(N, dtype=torch.int32, device=dev)
    bits = torch.empty((N, Lq // 8, BW), dtype=torch.int32, device=dev)
    kernels.TB.launch(q.data_ptr(), w.data_ptr(), qlens.data_ptr(), N, Lq,
                      match, mismatch, fg, ext, score.data_ptr(),
                      qend.data_ptr(), lane.data_ptr(), bits.data_ptr())
    return score, qend, lane, bits


def banded_sw_tb(q, w, qlens, scoring: ScoringConfig):
    """Banded SW emitting traceback codes.  q (N, Lq) uint8 codes, w
    (N, Lq + 256) window codes, qlens (N,) int32.  Returns (score, qend,
    lane, bits) with bits (N, Lq/8, 128) int32.

    The plain version writes the codes of all Lq steps; the kernel stops
    each row at the end of the word that holds step qlen - 1 and zeroes
    the words after it (the walk never reads them)."""
    q = q.to(torch.uint8).contiguous()
    w = w.to(torch.uint8).contiguous()
    qlens = qlens.to(torch.int32).contiguous()
    if w.shape[1] != q.shape[1] + 2 * BW:
        raise ValueError(f'window width {w.shape[1]} != Lq + {2 * BW}')
    fn = _tb_cuda if kernels.on_card(q) else _tb_torch
    return fn(q, w, qlens, **_scores(scoring))


# ---------------------------------------------------------------------------
# The path walk
# ---------------------------------------------------------------------------

def _walk_torch(bits, qend, lane, T: int):
    """Plain version of walk_kernel (fslr_tpu.ops.traceback._walk_device):
    T lockstep steps over all rows.  Returns (emits (N, T) uint8 [255 =
    no emit, else OP_M/I/D], n_ops, i_fin, l_fin)."""
    N, R, _ = bits.shape
    Lq = R * 8
    dev = bits.device
    flat = bits.reshape(N, R * BW)       # per-row index space, never N * R
    i = qend.long().clone()
    l = lane.long().clone()
    st = torch.zeros(N, dtype=torch.int8, device=dev)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    emits = torch.full((N, T), _NONE, dtype=torch.uint8, device=dev)
    for t in range(T):
        # a finished row changes nothing: stop once every row has
        if t % 64 == 0 and not bool(active.any()):
            break
        ii = i.clamp(0, Lq - 1)
        ll = l.clamp(0, BW - 1)
        word = torch.gather(flat, 1, ((ii >> 3) * BW + ll)[:, None])[:, 0]
        code = (word.long() >> ((ii & 7) * 4)) & 15
        src = code & 3
        e_ext = (code & 4) != 0
        f_ext = (code & 8) != 0
        is_h = active & (st == 0)
        stop = is_h & (src == 0)
        diag = is_h & (src == 1)
        to_e = is_h & (src == 2)
        to_f = is_h & (src == 3)
        in_e = active & (st == 1)
        in_f = active & (st == 2)
        emits[:, t] = torch.where(
            diag, OP_M, torch.where(in_e, OP_I, torch.where(
                in_f, OP_D, _NONE))).to(torch.uint8)
        st = torch.where(to_e, 1, torch.where(to_f, 2, st)).to(torch.int8)
        st = st.masked_fill((in_e & ~e_ext) | (in_f & ~f_ext), 0)
        i = i - (diag | in_e).long()
        l = l + in_e.long() - in_f.long()
        active = active & ~stop & (i >= 0)
    n_ops = (emits != _NONE).sum(dim=1)
    return emits, n_ops, i, l


def _pack_walk(score, qend, lane, emits, n_ops, i_fin, l_fin):
    """(6, N) int32 [score, qend, lane, i_fin + 1, l_fin, n_ops] and the
    2-bit packed emits (N, T/4) uint8 (codes 0/1/2, 3 = none; step t in
    bits 2 * (t % 4) of byte t / 4), as fslr_tpu's _extend_walk_impl."""
    packed = torch.stack([score.to(torch.int32), qend.to(torch.int32),
                          lane.to(torch.int32), (i_fin + 1).to(torch.int32),
                          l_fin.to(torch.int32), n_ops.to(torch.int32)])
    N, T = emits.shape
    e2 = emits.masked_fill(emits == _NONE, 3).reshape(N, T // 4, 4).long()
    weights = torch.tensor([1, 4, 16, 64], dtype=torch.long,
                           device=emits.device)
    return packed, (e2 * weights).sum(dim=2).to(torch.uint8)


def _walk_cuda(bits, score, qend, lane):
    N, R, _ = bits.shape
    Lq = R * 8
    dev = bits.device
    if Lq % 16:
        raise ValueError(f'query width {Lq} is not a multiple of 16')
    kernels.check(bits, 'bits', torch.int32, (N, R, BW), dev)
    kernels.check(score, 'score', torch.float32, (N,), dev)
    kernels.check(qend, 'qend', torch.int32, (N,), dev)
    kernels.check(lane, 'lane', torch.int32, (N,), dev)
    packed = torch.empty((6, N), dtype=torch.int32, device=dev)
    emits = torch.empty((N, (Lq + BW) // 4), dtype=torch.uint8, device=dev)
    kernels.WALK.launch(bits.data_ptr(), score.data_ptr(), qend.data_ptr(),
                        lane.data_ptr(), N, Lq, packed.data_ptr(),
                        emits.data_ptr())
    return packed, emits


def walk(bits, score, qend, lane):
    """Trace every alignment back from (qend, lane) through ``bits``.
    Returns (packed (6, N) int32 [score, qend, lane, qstart, l_fin, n_ops],
    emits (N, T/4) uint8 2-bit packed, T = Lq + 128)."""
    if kernels.on_card(bits):
        return _walk_cuda(bits, score, qend, lane)
    T = bits.shape[1] * 8 + BW
    return _pack_walk(score, qend, lane, *_walk_torch(bits, qend, lane, T))


def banded_extend(q, qlens, ws, cmin, cmax, genome, scoring: ScoringConfig):
    """Traceback extension of every row against its genome window
    (fslr_tpu.ops.traceback._extend_walk_impl): window gather, tb pass,
    walk.

    Args: q (N, SL) uint8 read-slice codes; qlens (N,) int32; ws/cmin/cmax
    (N,) window starts and contig bounds (global genome coordinates);
    genome (G,) uint8 codes, on the device of q.
    Returns (packed (6, N) int32, emits (N, (SL + 128) / 4) uint8) as
    :func:`walk`."""
    w = _genome_windows(genome, ws.long(), 1, q.shape[1] + 2 * BW, cmin,
                        cmax)
    score, qend, lane, bits = banded_sw_tb(q, w, qlens, scoring)
    return walk(bits, score, qend, lane)


# ---------------------------------------------------------------------------
# Host decoders (copied from fslr_tpu.ops.traceback)
# ---------------------------------------------------------------------------

def finalize_scores(packed):
    """Score/end/begin columns of a fetched ``packed`` array."""
    p = np.asarray(packed)
    return p[0], p[1], p[2], p[3], p[4]


def finalize_extend(packed, emits_packed):
    """Host decode of :func:`walk`'s output (fslr_tpu.ops.traceback.
    finalize_extend): (score, qend, lane, qstart, l_fin, cigars)."""
    score, qend, lane, qstart, l_fin, _ = np.asarray(packed)
    return (score, qend, lane, qstart, l_fin,
            decode_emit_rows(np.asarray(emits_packed)))


# Byte-level boundary LUTs for decode_emit_rle: a packed byte holds 4
# codes; only bytes with an internal code change, or whose first code
# differs from the previous byte's last code, can contain a run boundary
# (~10 per row vs ~1000 codes), so the per-code expansion happens only at
# those bytes.
_B_CODES = (((np.arange(256, dtype=np.uint16)[:, None]
              >> np.array([0, 2, 4, 6])) & 3).astype(np.uint8))   # (256,4)
_B_FIRST = _B_CODES[:, 0].copy()
_B_LAST = _B_CODES[:, 3].copy()
_B_INT_BRK = (_B_CODES[:, 1:] != _B_CODES[:, :-1]).any(axis=1)


def decode_emit_rle(blocks: np.ndarray):
    """Columnar RLE of a (n, t4) block of 2-bit-packed emit rows:
    (seg_row, seg_len, seg_op) numpy arrays in row order, op codes
    0/1/2 = M/I/D (BAM op numbering).  "none" codes (3) form their own
    runs, are dropped, and adjacent same-op runs they separated are
    merged."""
    n = len(blocks)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    t4 = blocks.shape[1]
    T = t4 * 4
    first = _B_FIRST[blocks]               # (n, t4)
    last = _B_LAST[blocks]
    prev_last = np.empty_like(last)
    prev_last[:, 0] = 255                  # row start: always a boundary
    prev_last[:, 1:] = last[:, :-1]
    cand = _B_INT_BRK[blocks] | (first != prev_last)
    rr_b, bb = np.nonzero(cand)            # candidate bytes, row-major
    codes4 = _B_CODES[blocks[rr_b, bb]]    # (m, 4)
    prevs = np.concatenate([prev_last[rr_b, bb][:, None],
                            codes4[:, :3]], axis=1)
    is_brk = codes4 != prevs               # (m, 4)
    mr, mo = np.nonzero(is_brk)            # still row-major, t ascending
    rr = rr_b[mr]
    tt = bb[mr] * 4 + mo
    flat = rr * np.int64(T) + tt
    lengths = np.diff(np.append(flat, n * np.int64(T)))
    vals = codes4[mr, mo]
    keep = vals != 3
    rr, tt = rr[keep], tt[keep]
    lengths, vals = lengths[keep], vals[keep]
    if not len(vals):
        z = np.zeros(0, np.int64)
        return z, z, z
    # emitted order is end->start: reverse run order within each row
    ordr = np.lexsort((-tt, rr))
    rr, lengths, vals = rr[ordr], lengths[ordr], vals[ordr]
    # merge adjacent same-op runs separated only by dropped none-runs
    new_seg = np.ones(len(vals), bool)
    new_seg[1:] = (rr[1:] != rr[:-1]) | (vals[1:] != vals[:-1])
    starts = np.flatnonzero(new_seg)
    seg_len = np.add.reduceat(lengths, starts)
    return (rr[starts].astype(np.int64), seg_len.astype(np.int64),
            vals[starts].astype(np.int64))


def decode_emit_rows(blocks: np.ndarray) -> list[list[tuple[int, str]]]:
    """CIGARs [(len, op_char), ...] of a whole (n, t4) block of 2-bit-packed
    emit rows, start -> end."""
    out: list[list] = [[] for _ in range(len(blocks))]
    seg_rows, seg_len, seg_ops = decode_emit_rle(blocks)
    for r, ln, op in zip(seg_rows.tolist(), seg_len.tolist(),
                         seg_ops.tolist()):
        out[r].append((int(ln), _OP_CHARS[op]))
    return out
