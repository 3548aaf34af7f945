"""Read-to-profile banded alignment with traceback codes: the POA core.

Counterpart of ``fslr_tpu/ops/profile_align.py``.  The partial-order graph
is kept column-merged (ops/poa.py): one column per topological rank with
its base counts.  Aligning a read to it is a banded affine DP against a
position-specific profile:

  * substitution score s(b, c): the count-weighted match/mismatch of read
    base b against column c, shipped as one int32 word per column holding
    4 x int8 fixed-point scores (x16); a read base >= 4 scores -8.0;
  * deleting column c costs its own extend cost, so with cumulative costs
    g[c] the lazy-F closed form becomes

        F[l] = max_{k<l} (H[k] + g[k]) - openF - g[l],

    still an exclusive prefix-max over the band lanes, now of H + g.

Lanes l = 0..127 are band offsets, query steps i are scanned, and cell
(i, l) covers profile column i + l.  Codes are those of ops/traceback.py
(4 bits a cell, 8 steps a word), so the same walk follows them.  Unlike
the score-only DP kernels the values are not integers (s is a multiple of
1/16, g a float32 of a float64 cumsum): the plain version and the kernel
keep the JAX operation order, so every rounding agrees.

``profile_banded_tb`` runs the plain version on CPU tensors and launches
``prof_kernel`` (csrc/profile.cu) on CUDA tensors.  Under an active mesh
``profile_align_walk`` runs the DP and the walk in row shards over it
(``parallel.dispatch.dp_call``), as the stages run their kernels; its
rows are independent, so the results are a plain call's.
"""

from __future__ import annotations

import numpy as np
import torch

from fslr_tpu_torch import instrument, kernels
from fslr_tpu_torch.config import ScoringConfig
from fslr_tpu_torch.ops import traceback as tb
from fslr_tpu_torch.ops.banded import BW
from fslr_tpu_torch.ops.ssw import (NEG, _cummax_exclusive, _init_state,
                                    _shift_left, _shift_right,
                                    first_gap_cost)
from fslr_tpu_torch.parallel import dispatch

SCALE = 16.0          # fixed-point scale of the packed int8 scores
PAD_BYTE = -128       # packed score for out-of-profile columns (-8.0)


def _scores(sc: ScoringConfig) -> dict:
    fg = first_gap_cost(sc)
    return dict(fg=fg, ext=float(sc.gap_extend),
                openF=fg - float(sc.gap_extend))


def _extract_score(word, qcol):
    """word (N, BW) int32 packed 4 x int8 scores; qcol (N, 1) read base.
    Returns (N, BW) float32 substitution scores."""
    v = (word.long() >> (qcol.clamp_max(3) * 8)) & 0xFF
    v = v - torch.where(v >= 128, 256, 0)
    s = v.float() * (1.0 / SCALE)
    return s.masked_fill(qcol >= 4, PAD_BYTE / SCALE)


def _prof_step(H, E, s, g, fg, ext, openF):
    """One query row with per-column deletion costs
    (fslr_tpu.ops.profile_align._prof_tb_step).  Returns (H, E, code)."""
    H_up = _shift_left(H)
    E_up = _shift_left(E)
    e_ext = (E_up - ext) >= (H_up - fg)
    E = torch.maximum(E_up - ext, H_up - fg)
    diag = H + s
    Hno = torch.clamp_min(torch.maximum(diag, E), 0.0)
    C = Hno + g
    Cm = _cummax_exclusive(C)
    F = Cm - openF - g
    f_ext = Cm > _shift_right(C, 1, NEG)
    pos = Hno > 0.0
    src = torch.where(F > Hno, 3,
                      torch.where((diag == Hno) & pos, 1,
                                  torch.where((E == Hno) & pos, 2, 0)))
    code = (src + e_ext.int() * 4 + f_ext.int() * 8).to(torch.int32)
    return torch.maximum(Hno, F), E, code


def _prof_torch(q, sp, g, qlens, *, fg, ext, openF):
    """Plain version of prof_kernel (fslr_tpu.ops.profile_align._prof_jax).
    Runs the steps up to the end of the word holding the longest row's
    last step; the codes of later words stay 0."""
    N, Lq = q.shape
    dev = q.device
    lidx = torch.arange(BW, dtype=torch.float32, device=dev).expand(N, BW)
    q = q.long()
    H, E, bestH, bestI = _init_state(N, dev)
    bits = torch.zeros((N, Lq // 8, BW), dtype=torch.int32, device=dev)
    n = min(Lq, (int(qlens.max()) + 7) & ~7) if N else 0
    for i in range(n):
        qcol = q[:, i:i + 1]
        s = _extract_score(sp[:, i:i + BW], qcol)
        H, E, code = _prof_step(H, E, s, g[:, i:i + BW], fg, ext, openF)
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


def _prof_cuda(q, sp, g, qlens, *, fg, ext, openF):
    N, Lq = q.shape
    dev = q.device
    score = torch.empty(N, dtype=torch.float32, device=dev)
    qend = torch.empty(N, dtype=torch.int32, device=dev)
    lane = torch.empty(N, dtype=torch.int32, device=dev)
    bits = torch.empty((N, Lq // 8, BW), dtype=torch.int32, device=dev)
    kernels.PROF.launch(q, sp, g, qlens, N, Lq, fg, ext, openF, score, qend,
                        lane, bits)
    return score, qend, lane, bits


def profile_banded_tb(q, sp, g, qlens, scoring: ScoringConfig):
    """Banded read-vs-profile alignment emitting traceback codes.

    q (N, Lq) uint8 read codes (4 = pad), Lq % 128 == 0; sp (N, Lq + 256)
    int32 packed per-column scores (byte b = score of read base b, x16);
    g (N, Lq + 256) float32 cumulative per-column deletion costs; qlens
    (N,) int32.  Returns (score, qend, lane, bits (N, Lq/8, 128) int32).
    Codes are defined in the words that hold a row's steps < qlen; the
    kernel writes zeros after them."""
    N, Lq = q.shape
    dev = q.device
    if Lq % 128:
        raise ValueError(f'query width {Lq} is not a multiple of 128')
    q = q.to(torch.uint8).contiguous()
    sp = sp.to(torch.int32).contiguous()
    g = g.to(torch.float32).contiguous()
    qlens = qlens.to(torch.int32).contiguous()
    kernels.check(q, 'q', torch.uint8, (N, Lq), dev)
    kernels.check(sp, 'sp', torch.int32, (N, Lq + 2 * BW), dev)
    kernels.check(g, 'g', torch.float32, (N, Lq + 2 * BW), dev)
    kernels.check(qlens, 'qlens', torch.int32, (N,), dev)
    fn = _prof_cuda if kernels.on_card(q) else _prof_torch
    return fn(q, sp, g, qlens, **_scores(scoring))


def _profile_walk(q, sp, g, qlens, scoring: ScoringConfig):
    """(score, packed (6, N), emits) of the profile DP and its walk."""
    score, qend, lane, bits = profile_banded_tb(q, sp, g, qlens, scoring)
    return (score, *tb.walk(bits, score, qend, lane))


def profile_align_walk(q, sp, g, qlens, scoring: ScoringConfig):
    """The profile DP, then the traceback walk (ops/traceback.walk, T =
    Lq + 128) on q's device; decoded on the host.  ``qlens`` lies on the
    host (a numpy array or a CPU tensor): it counts the DP cells without
    waiting for the card.  Returns (score float32, qend, lane, qstart,
    l_fin, cigars)."""
    qlens = np.asarray(qlens, np.int32)
    instrument.add_cells(int(qlens.sum(dtype=np.int64)) * int(g.shape[-1]),
                         'profile')
    score, packed, emits = dispatch.dp_call(
        _profile_walk, (q, sp, g, torch.from_numpy(qlens).to(q.device)),
        statics=(scoring,), out_dims=(0, 1, 0))
    _, qend, lane, qstart, l_fin, cigars = tb.finalize_extend(
        packed.cpu().numpy(), emits.cpu().numpy())
    return (score.cpu().numpy().astype(np.float32), qend, lane, qstart,
            l_fin, cigars)
