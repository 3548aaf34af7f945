"""Tandem-repeat masking: a tantan-equivalent forward-backward HMM.

Counterpart of ``fslr_tpu/ops/tantan.py``: a background state b and
repeat states r_d for periods d = 1..P; b->r_d proportional to decay^d
summing to repeat_start, r_d->b = repeat_end; r_d emits a base matching
seq[i-d] with match_prob (N compares with ratio 1, a period not yet
started with ratio 0).  A position is masked when its posterior
P(repeat) >= posterior_threshold, inside the read and not N.

The plain version mirrors the scan reference ``_mask_impl`` (float32,
normalised per position); the CUDA kernel (``csrc/tantan.cu``) computes
the same recurrences with sums taken in another order.
"""

from __future__ import annotations

import torch

from fslr_tpu_torch import kernels
from fslr_tpu_torch.config import JunkFilterConfig

MAX_PERIOD = 128      # states per kernel block


def _start_d(cfg: JunkFilterConfig, device):
    """The b->r_d transition vector, as _mask_impl computes it."""
    d_idx = torch.arange(1, cfg.mask_max_period + 1, dtype=torch.float32,
                         device=device)
    sd = cfg.mask_decay ** d_idx
    return sd / sd.sum() * cfg.mask_repeat_start


def _params(cfg: JunkFilterConfig) -> dict:
    return dict(stay_b=1.0 - cfg.mask_repeat_start,
                stay_r=1.0 - cfg.mask_repeat_end,
                end_p=cfg.mask_repeat_end,
                match_ratio=cfg.mask_match_prob / 0.25,
                mismatch_ratio=(1.0 - cfg.mask_match_prob) / 3.0 / 0.25)


def _emission(win, x, match_ratio, mismatch_ratio):
    xb = x[:, None]
    er = torch.where(xb == win, match_ratio, mismatch_ratio)
    er = er.masked_fill((xb == 4) | (win == 4), 1.0)
    return er.masked_fill(win == 5, 0.0)


def _posterior_torch(seq, cfg: JunkFilterConfig):
    """Plain version of mask_kernel: the (B, L) repeat posterior
    (fslr_tpu.ops.tantan._mask_impl before thresholding)."""
    B, L = seq.shape
    P = cfg.mask_max_period
    p = _params(cfg)
    stay_b, stay_r, end_p = p['stay_b'], p['stay_r'], p['end_p']
    mr, mm = p['match_ratio'], p['mismatch_ratio']
    start_d = _start_d(cfg, seq.device)[None, :]
    seq = seq.long()
    f32 = dict(dtype=torch.float32, device=seq.device)

    # window[b, d-1] = seq[b, i-d]; 5 = no base yet
    win = torch.full((B, P), 5, dtype=torch.long, device=seq.device)
    fb = torch.ones(B, **f32)
    fr = torch.zeros((B, P), **f32)
    fb_all = torch.empty((L, B), **f32)
    fr_all = torch.empty((L, B, P), **f32)
    for i in range(L):
        x = seq[:, i]
        er = _emission(win, x, mr, mm)
        fr_new = (fr * stay_r + fb[:, None] * start_d) * er
        fb_new = fb * stay_b + fr.sum(dim=1) * end_p
        z = torch.clamp_min(fb_new + fr_new.sum(dim=1), 1e-30)
        fb = fb_new / z
        fr = fr_new / z[:, None]
        fb_all[i] = fb
        fr_all[i] = fr
        win = torch.roll(win, 1, dims=1)
        win[:, 0] = x

    # backward: beta_{L-1} = 1; each step first emits the incoming carry,
    # then steps with the emission at p against window(p)
    seq_ext = torch.cat([torch.full((B, P), 5, dtype=torch.long,
                                    device=seq.device), seq], dim=1)
    bb = torch.ones(B, **f32)
    br = torch.ones((B, P), **f32)
    post = torch.empty((L, B), **f32)
    for p_ in range(L - 1, -1, -1):
        num = (fr_all[p_] * br).sum(dim=1)
        den = num + fb_all[p_] * bb
        post[p_] = num / torch.clamp_min(den, 1e-30)
        win = torch.roll(win, -1, dims=1)
        win[:, P - 1] = seq_ext[:, p_]            # seq[p - P]
        w = _emission(win, seq[:, p_], mr, mm) * br
        bb_new = stay_b * bb + (start_d * w).sum(dim=1)
        br_new = stay_r * w + end_p * bb[:, None]
        z = torch.clamp_min(bb_new + br_new.sum(dim=1), 1e-30)
        bb = bb_new / z
        br = br_new / z[:, None]
    return post.T


def _posterior_cuda(seq, cfg: JunkFilterConfig):
    """Launch mask_kernel: the (B, L) float32 repeat posterior."""
    B, L = seq.shape
    P = cfg.mask_max_period
    dev = seq.device
    if P > MAX_PERIOD:
        raise ValueError(f'mask_max_period {P} > {MAX_PERIOD}')
    if L > 48 * 1024:
        raise ValueError(f'read length bucket {L} exceeds shared memory')
    kernels.check(seq, 'seq', torch.uint8, (B, L), dev)
    start_d = _start_d(cfg, dev).contiguous()
    fr_all = torch.empty(B * L * MAX_PERIOD, dtype=torch.float32,
                         device=dev)
    fb_all = torch.empty(B * L, dtype=torch.float32, device=dev)
    post = torch.empty((B, L), dtype=torch.float32, device=dev)
    p = _params(cfg)
    kernels.MASK.launch(seq.data_ptr(), B, L, P, start_d.data_ptr(),
                        p['stay_b'], p['stay_r'], p['end_p'],
                        p['match_ratio'], p['mismatch_ratio'],
                        fr_all.data_ptr(), fb_all.data_ptr(), post.data_ptr())
    return post


def repeat_posterior(seq, cfg: JunkFilterConfig):
    """(B, L) float32 posterior P(repeat) of encoded reads (uint8)."""
    seq = seq.to(torch.uint8).contiguous()
    fn = _posterior_cuda if kernels.on_card(seq) else _posterior_torch
    return fn(seq, cfg)


def repeat_mask(seq, lens, cfg: JunkFilterConfig):
    """Boolean repeat mask (B, L) for encoded reads (uint8, 4 = N)."""
    seq = seq.to(torch.uint8)
    mask = repeat_posterior(seq, cfg) >= cfg.mask_posterior_threshold
    pos = torch.arange(seq.shape[1], device=seq.device)[None, :]
    return mask & (pos < lens[:, None]) & (seq != 4)
