"""Split-alignment selection DP (the dodi equivalent), as torch ops.

Counterpart of ``fslr_tpu/ops/selection.py``.  Per read, candidates sorted
by query end (stable); dp[i] = s_i + max(0, max_{j<i} dp[j] - ol_cost *
overlap(j, i)) over predecessors overlapping by at most max_overlap; the
best chain is walked back through parent pointers.  float32 throughout,
as in the JAX package.
"""

from __future__ import annotations

import torch

from fslr_tpu_torch import instrument

NEG = -1e30


def _select(qstart, qend, s_sel, valid, ol_cost: float, max_overlap: float):
    B, C = qstart.shape
    dev = qstart.device
    qs = torch.where(valid, qstart, 2 ** 30).float()
    qe = torch.where(valid, qend, 2 ** 30).float()
    order = torch.sort(qe, dim=1, stable=True).indices
    qs = torch.gather(qs, 1, order)
    qe = torch.gather(qe, 1, order)
    sc = torch.gather(s_sel.masked_fill(~valid, NEG), 1, order)
    v = torch.gather(valid, 1, order)

    dp = torch.full((B, C), NEG, dtype=torch.float32, device=dev)
    parent = torch.full((B, C), -1, dtype=torch.long, device=dev)
    cols = torch.arange(C, device=dev)[None, :]
    for i in range(C):
        ov = torch.clamp_min(qe - qs[:, i:i + 1], 0.0)   # overlap(j, i)
        allowed = (cols < i) & (ov <= max_overlap)
        cand = torch.where(allowed, dp - ol_cost * ov, NEG)
        bestj = torch.argmax(cand, dim=1)               # first maximum
        bestv = torch.gather(cand, 1, bestj[:, None])[:, 0]
        di = sc[:, i] + torch.clamp_min(bestv, 0.0)
        dp[:, i] = torch.where(v[:, i], di, NEG)
        parent[:, i] = torch.where((bestv > 0.0) & v[:, i], bestj, -1)

    end = torch.argmax(dp, dim=1)
    cur = torch.where(v.any(dim=1), end, -1)
    chosen = torch.zeros((B, C), dtype=torch.bool, device=dev)
    for _ in range(C):
        ok = cur >= 0
        cur_c = torch.clamp_min(cur, 0)
        chosen |= ok[:, None] & (cols == cur_c[:, None])
        nxt = torch.gather(parent, 1, cur_c[:, None])[:, 0]
        cur = torch.where(ok, nxt, -1)
    chosen_orig = torch.zeros_like(chosen).scatter_(1, order, chosen)
    return chosen_orig & valid


def select_alignments(qstart, qend, score, valid, *, ol_cost=2,
                      max_overlap=50_000, bias=None, min_score=21):
    """(B, C) bool mask of the selected candidates.  ``bias``: optional
    (B, C) multiplier applied to scores for selection only (region
    bias)."""
    score = score.float()
    s_sel = score if bias is None else score * bias.float()
    valid = valid & (score >= min_score)
    B, C = qstart.shape
    instrument.add_cells(B * C * C, 'select')
    return _select(qstart, qend, s_sel, valid, float(ol_cost),
                   float(max_overlap))
