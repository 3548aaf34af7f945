"""Repeat-block scoring for the junk filter, as torch ops.

Counterpart of ``fslr_tpu/ops/kmer_stats.py``.  A repeat block (a maximal
masked run) is junk iff length > 150, telomere 6-mer share <= 0.3 and the
k-mer reuse score rep >= 0.3; a read is junk iff one of its blocks is.

* ``junk_gates``: the cheap per-read gate (length + telomere share only,
  by row-wise cumsum/cummax); junk implies the gate.
* ``junk_blocks``: the full decision, rep included.  Sorting (block,
  k-mer code, position) keys makes "distance to the previous occurrence
  of the same k-mer in the block" a neighbour difference.

Every sort is stable, as ``np.lexsort`` and JAX's sorts are.
"""

from __future__ import annotations

import functools
from collections import deque

import numpy as np
import torch

from fslr_tpu_torch.config import JunkFilterConfig
from fslr_tpu_torch.encode import NUM_SYMBOLS, encode, revcomp_str

# Telomere variant hexamers (the reference filter_junk_from_fq.py:208-209)
TEL_TARGETS = ["CCCTAA", "CCCTGA", "CCCGAA", "CCCTAC", "CCCTCA", "CCCCAA",
               "CCCTTA", "CCCTAT", "CCCTAG", "CCCAAA", "CCCACT", "CCCCAT",
               "CCCGCA", "CCCGCT", "CCCTCT"]

_I32 = torch.int32


def tel_rotations(targets=None) -> set[str]:
    """Rotation closure as the reference builds it: deque.rotate() applied
    len-1 times per token (the identity rotation is excluded), over the
    targets and their reverse complements."""
    targets = list(targets or TEL_TARGETS)
    targets = targets + [revcomp_str(t) for t in targets]
    rot: set[str] = set()
    for t in targets:
        d = deque(t)
        for _ in range(len(t) - 1):
            d.rotate()
            rot.add(''.join(d))
    return rot


@functools.lru_cache(maxsize=4)
def telomere_table(k: int = 6) -> np.ndarray:
    """(5^k,) bool membership table over base-5 k-mer codes."""
    table = np.zeros(NUM_SYMBOLS ** k, dtype=bool)
    for s in tel_rotations():
        code = 0
        for c in encode(s):
            code = code * NUM_SYMBOLS + int(c)
        table[code] = True
    return table


@functools.lru_cache(maxsize=4)
def telomere_codes(k: int = 6) -> tuple[int, ...]:
    """Sorted base-5 codes of the telomere rotation closure."""
    return tuple(int(i) for i in np.flatnonzero(telomere_table(k)))


def _shift_in(x, j: int, fill):
    """x[:, p] -> x[:, p+j]; the last j columns take ``fill``."""
    out = torch.full_like(x, fill)
    out[:, :x.shape[1] - j] = x[:, j:]
    return out


def _kmer_codes_2d(seq, k: int):
    """(B, L) base-5 rolling k-mer codes; positions past L read 4."""
    seq = seq.to(_I32)
    c = torch.zeros_like(seq)
    for p in range(k):
        c = c * NUM_SYMBOLS + _shift_in(seq, p, 4)
    return c


def _in_read(seq, lens, mask):
    pos = torch.arange(seq.shape[1], dtype=_I32, device=seq.device)[None, :]
    return mask & (pos < lens[:, None]), pos


def junk_gates(seq, lens, mask, cfg: JunkFilterConfig):
    """Per-read (B,) bool: some repeat run passes the block-length and
    telomere gates, i.e. the read might be junk and needs the rep score.
    junk_blocks(...) implies junk_gates(...)."""
    mask, pos = _in_read(seq, lens, mask)
    prev = torch.nn.functional.pad(mask, (1, 0))[:, :-1]
    nxt = _shift_in(mask, 1, False)
    is_start = mask & ~prev
    is_end = mask & ~nxt
    contig6 = mask
    for j in range(1, 6):
        contig6 = contig6 & _shift_in(mask, j, False)
    codes = torch.tensor(telomere_codes(6), dtype=_I32, device=seq.device)
    member = torch.isin(_kmer_codes_2d(seq, 6), codes) & contig6
    S = torch.cumsum(member.to(_I32), dim=1, dtype=_I32)
    E = S - member.to(_I32)
    base = torch.cummax(torch.where(is_start, E, -1), dim=1).values
    s_pos = torch.cummax(torch.where(is_start, pos, -1), dim=1).values
    blen = pos - s_pos + 1
    tel_pct = (S - base).float() / torch.clamp_min(blen - 5, 1).float()
    gate = (is_end & (blen > cfg.min_block_length)
            & (tel_pct <= float(cfg.telomere_pct_threshold)))
    return gate.any(dim=1)


def junk_blocks(seq, lens, mask, cfg: JunkFilterConfig, tel_table=None):
    """Per-read (B,) bool junk decision from the repeat mask;
    ``tel_table``: the (5^6,) bool telomere 6-mer table to use (default
    :func:`telomere_table`)."""
    junk, _ = junk_blocks_debug(seq, lens, mask, cfg, tel_table)
    return junk


def _segment_sum(vals, seg, R):
    return torch.zeros(R, dtype=vals.dtype, device=vals.device) \
        .index_add_(0, seg, vals)


def junk_blocks_debug(seq, lens, mask, cfg: JunkFilterConfig,
                      tel_table=None):
    """Junk decision plus per-run (blen, tel_pct, rep, read_id, start)."""
    B, L = seq.shape
    dev = seq.device
    N = B * L
    R = N // 2 + 2            # max possible runs + trash segment
    trash = R - 1
    mask, pos = _in_read(seq, lens, mask)
    prev = torch.nn.functional.pad(mask, (1, 0))[:, :-1]
    starts = mask & ~prev
    rid2d = torch.cumsum(starts.reshape(-1), 0, dtype=_I32).reshape(B, L) - 1
    rid2d = torch.where(mask, rid2d, trash)
    flat_rid = rid2d.reshape(-1).long()
    flat_mask = mask.reshape(-1)
    row = torch.arange(B, dtype=_I32, device=dev)[:, None].expand(B, L) \
        .reshape(-1)
    col = pos.expand(B, L).reshape(-1)

    blen = _segment_sum(flat_mask.to(_I32), flat_rid, R)
    bid = torch.full((R,), torch.iinfo(_I32).min, dtype=_I32, device=dev) \
        .scatter_reduce_(0, flat_rid, torch.where(flat_mask, row, -1),
                         'amax')
    bstart = torch.full((R,), torch.iinfo(_I32).max, dtype=_I32,
                        device=dev) \
        .scatter_reduce_(0, flat_rid, torch.where(flat_mask, col, L + 1),
                         'amin')

    # telomere content per block
    c6 = _kmer_codes_2d(seq, 6)
    valid6 = mask & (rid2d == _shift_in(rid2d, 5, trash))
    table = torch.as_tensor(telomere_table(6) if tel_table is None
                            else tel_table, device=dev).bool()
    member = table[c6.long()] & valid6
    tel_cnt = _segment_sum(member.reshape(-1).to(_I32), flat_rid, R)
    tel_pct = tel_cnt.float() / torch.clamp_min(blen - 5, 1).float()

    # compute_rep per block: stable sort by (run id, k-mer code, position)
    tot_amount = torch.zeros(R, dtype=torch.float32, device=dev)
    for k in (2, 3, 4, 5, 6):
        ck = _kmer_codes_2d(seq, k).reshape(-1)
        # visited iff the k-mer AND position i+k lie in the same block
        visited = flat_mask & (flat_rid == _shift_in(rid2d, k, trash)
                               .reshape(-1).long())
        srid_in = torch.where(visited, flat_rid, trash)
        key = (srid_in * NUM_SYMBOLS ** k + ck.long()) * L + col.long()
        order = torch.sort(key, stable=True).indices
        srid = srid_in[order]
        scode = ck[order]
        scol = col[order]
        same = ((srid == torch.roll(srid, 1)) & (scode == torch.roll(scode, 1))
                & (srid != trash))
        same[0] = False
        d = scol - torch.roll(scol, 1)
        amount = torch.exp(-(0.25 / k) * (d.float() - 1.0)).masked_fill(
            ~same, 0.0)
        amount = amount.masked_fill(scol - bstart[srid] <= k, 0.0)
        tot_amount = tot_amount + _segment_sum(amount, srid, R)

    total_seen = torch.zeros(R, dtype=_I32, device=dev)
    for k in (2, 3, 4, 5, 6):
        total_seen = total_seen + torch.clamp_min(blen - 2 * k - 1, 0)
    rep = torch.where(total_seen > 0,
                      tot_amount / torch.clamp_min(total_seen, 1).float(),
                      0.0)
    junk_block = ((blen > cfg.min_block_length)
                  & (tel_pct <= float(cfg.telomere_pct_threshold))
                  & (rep >= float(cfg.rep_threshold)))
    junk_block[trash] = False
    junk_read = torch.zeros(B, dtype=torch.bool, device=dev)
    junk_read[bid[junk_block].long()] = True
    return junk_read, (blen, tel_pct, rep, bid, bstart)
