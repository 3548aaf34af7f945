"""Batched greedy Jaccard similarity over breakpoint-interval lists.

Counterpart of ``fslr_tpu/ops/jaccard.py`` (the reference's
``overall_jaccard_similarity``): for each read pair, the intervals of the
first read are matched in list order to the FIRST unused interval of the
second read on the same chromosome whose reciprocal overlap (the overlap
divided by each interval's query ``aln_size``) is >= ``percentage``;
jaccard = matches / (len1 + len2 - matches).  The device version runs in
float32, as the JAX one does; :func:`jaccard_host` is the exact host
mirror used for reads whose lists exceed the table width M.
"""

from __future__ import annotations

import numpy as np
import torch


def _jaccard_impl(c1, s1, e1, z1, v1, c2, s2, e2, z2, v2, len1, len2,
                  pct: float, M: int):
    """(j float32, matches int32) per row of the (N, M) interval tables."""
    N = c1.shape[0]
    used = torch.zeros((N, M), dtype=torch.bool, device=c1.device)
    inter = torch.zeros(N, dtype=torch.int32, device=c1.device)
    lanes = torch.arange(M, device=c1.device)[None, :]
    s2f, e2f = s2.float(), e2.float()
    z2c = z2.clamp_min(1e-9)
    for i in range(M):
        ov = (torch.minimum(e1[:, i:i + 1].float(), e2f)
              - torch.maximum(s1[:, i:i + 1].float(), s2f)).clamp_min(0.0)
        rec = torch.minimum(ov / z1[:, i:i + 1].clamp_min(1e-9), ov / z2c)
        match = (v1[:, i:i + 1] & v2 & ~used & (c1[:, i:i + 1] == c2)
                 & (rec >= pct))
        any_m = match.any(dim=1)
        jm = match.to(torch.uint8).argmax(dim=1)            # first True
        used |= (lanes == jm[:, None]) & any_m[:, None]
        inter += any_m.int()
    union = len1 + len2 - inter
    j = torch.where(union > 0,
                    inter.float() / union.clamp_min(1).float(),
                    torch.zeros((), dtype=torch.float32, device=c1.device))
    return j, inter


def upload_interval_arrays(chrom, start, end, size, lens,
                           device: torch.device):
    """The per-read (R, M) interval tables and the (R,) list lengths
    (valid slots are those below the length) on ``device``, once; every
    :func:`jaccard_pairs_indexed` call gathers from them."""
    return tuple(torch.as_tensor(np.ascontiguousarray(x), device=device)
                 for x in (chrom, start, end,
                           np.asarray(size, np.float32),
                           np.asarray(lens, np.int32)))


def jaccard_pairs_indexed(pairs, chrom, start, end, size, lens,
                          percentage: float, M: int = 32,
                          chunk: int = 1 << 18):
    """Pair similarities via gathers from the uploaded tables.

    pairs: (N, 2) read indices (the first read's list is matched in
    order -- the greedy match is role-dependent); chrom/start/end/size/
    lens: from :func:`upload_interval_arrays`.  Returns (j float32, n_i
    int32) numpy arrays of length N."""
    N = len(pairs)
    js = np.zeros(N, np.float32)
    ns = np.zeros(N, np.int32)
    pairs = torch.as_tensor(np.asarray(pairs, np.int64).reshape(-1, 2),
                            device=chrom.device)
    iota = torch.arange(M, device=chrom.device)[None, :]
    for off in range(0, N, chunk):
        a, b = pairs[off:off + chunk, 0], pairs[off:off + chunk, 1]
        la, lb = lens[a], lens[b]
        j, n_i = _jaccard_impl(
            chrom[a], start[a], end[a], size[a], iota < la[:, None],
            chrom[b], start[b], end[b], size[b], iota < lb[:, None],
            la, lb, float(percentage), M)
        js[off:off + len(a)] = j.cpu().numpy()
        ns[off:off + len(a)] = n_i.cpu().numpy()
    return js, ns


def jaccard_pairs(lists1, lists2, percentage: float, M: int = 32, *,
                  device: torch.device):
    """fslr_tpu's list API: lists1 / lists2 are N per-read interval lists
    of (chrom, start, end, aln_size) tuples, pair n is (lists1[n],
    lists2[n]).  Both go into one table of 2N reads on ``device`` and
    :func:`jaccard_pairs_indexed` values the pairs (n, N + n); pairs with
    a list longer than M take :func:`jaccard_host`.  Returns (j float32,
    n_i int32) numpy arrays."""
    N = len(lists1)
    if N == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    chrom = np.zeros((2 * N, M), np.int32)
    start = np.zeros((2 * N, M), np.int32)
    end = np.zeros((2 * N, M), np.int32)
    size = np.zeros((2 * N, M), np.float32)
    lens = np.zeros(2 * N, np.int32)
    over = []
    for n, pair in enumerate(zip(lists1, lists2)):
        if max(len(lst) for lst in pair) > M:
            over.append(n)
            continue
        for r, lst in ((n, pair[0]), (N + n, pair[1])):
            lens[r] = len(lst)
            for i, (c, s, e, z) in enumerate(lst):
                chrom[r, i], start[r, i], end[r, i], size[r, i] = c, s, e, z
    pairs = np.stack([np.arange(N), np.arange(N, 2 * N)], 1)
    j, n_i = jaccard_pairs_indexed(
        pairs, *upload_interval_arrays(chrom, start, end, size, lens,
                                       device), percentage, M)
    for n in over:
        j[n], n_i[n] = jaccard_host(lists1[n], lists2[n], percentage)
    return j, n_i


def jaccard_host(l1, l2, percentage):
    """Exact host mirror (same greedy-first-match semantics)."""
    if not l1 or not l2:
        return 0.0, 0
    used = [False] * len(l2)
    inter = 0
    for (c, s, e, z) in l1:
        for jn, (c2_, s2_, e2_, z2_) in enumerate(l2):
            if used[jn]:
                continue
            ov = max(0, min(e, e2_) - max(s, s2_))
            if c == c2_ and z > 0 and z2_ > 0 \
                    and min(ov / z, ov / z2_) >= percentage:
                used[jn] = True
                inter += 1
                break
    union = len(l1) + len(l2) - inter
    if union == 0:
        return 0.0, 0
    return inter / union, inter
