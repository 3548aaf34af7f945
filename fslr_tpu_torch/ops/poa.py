"""Per-cluster consensus: batched POA (profile graph) and pileup engines.

Counterpart of ``fslr_tpu/ops/poa.py`` (the reference's abpoa step), with
the same consensus strings:

* ``engine='poa'`` (default): partial-order consensus with the graph kept
  column-merged (aligned nodes of one rank share a column).  Round r
  aligns every cluster's r-th member against its current profile graph in
  one batched call per length bucket (ops/profile_align.py: prof_kernel
  and the walk on the device), then opens columns for insertions and adds
  base and span counts on the host.  Consensus = majority call per column.
* ``engine='pileup'``: every member is banded-aligned against the
  cluster's backbone in one batched call (ops/traceback.banded_sw_tb:
  tb_kernel and the walk on the device), and per-backbone-column votes
  decide.

As in the JAX package: members beyond ``max_reads_per_cluster`` are
subsampled evenly, reads scoring < 30% of a perfect alignment are left
out, and the band is a fixed 128 columns.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from fslr_tpu_torch.config import ConsensusConfig, ScoringConfig
from fslr_tpu_torch.encode import decode, encode
from fslr_tpu_torch.ops import profile_align as pa
from fslr_tpu_torch.ops import traceback as tb


def _pad128(n):
    return ((n + 127) // 128) * 128


def consensus_sequences(clusters: list[list[str]], cfg: ConsensusConfig,
                        device: torch.device) -> list[str]:
    """clusters: list of member sequence lists (first member = backbone).
    Returns one consensus string per cluster."""
    if getattr(cfg, 'engine', 'poa') == 'poa':
        return consensus_sequences_poa(clusters, cfg, device)
    cons = _consensus_once(clusters, cfg, device)
    for _ in range(max(cfg.refine_iterations, 0)):
        refined_in = []
        for ci, members in enumerate(clusters):
            members = [m for m in members if m]
            if not members or not cons[ci]:
                refined_in.append(members)
            else:
                refined_in.append([cons[ci]] + members)
        cons = _consensus_once(refined_in, cfg, device)
    return cons


def _consensus_once(clusters: list[list[str]], cfg: ConsensusConfig,
                    device: torch.device) -> list[str]:
    sc = ScoringConfig(gap_open_is_first_base=False)
    jobs = []          # (cluster_idx, member_seq, backbone)
    backbones = []
    for ci, members in enumerate(clusters):
        members = [m for m in members if m]
        if not members:
            backbones.append('')
            continue
        backbone = members[0]
        backbones.append(backbone)
        rest = members[1:]
        cap = cfg.max_reads_per_cluster - 1
        if len(rest) > cap:
            idx = np.linspace(0, len(rest) - 1, cap).astype(int)
            rest = [rest[i] for i in idx]
        for m in rest:
            jobs.append((ci, m, backbone))

    by_bucket: dict[int, list[int]] = {}
    for ji, (ci, m, b) in enumerate(jobs):
        L = _pad128(min(max(len(m), 1), cfg.max_length))
        by_bucket.setdefault(L, []).append(ji)

    piles = {}         # cluster -> (base_votes, del_votes, ins, n_members)
    for ci, backbone in enumerate(backbones):
        if not backbone:
            continue
        Lb = len(backbone)
        piles[ci] = (np.zeros((Lb, 4), np.int32), np.zeros(Lb, np.int32),
                     {}, 1)

    for L, jidx in sorted(by_bucket.items()):
        N = len(jidx)
        q = np.full((N, L), 4, np.uint8)
        w = np.full((N, L + 256), 4, np.uint8)
        qlens = np.zeros(N, np.int32)
        for r, ji in enumerate(jidx):
            ci, m, b = jobs[ji]
            mc = encode(m)[:L]
            q[r, :len(mc)] = mc
            qlens[r] = len(mc)
            # centre the backbone in the band: window starts 128 before
            bc = encode(b)[:L + 128]
            w[r, 128:128 + len(bc)] = bc
        score, qend, lane, bits = tb.banded_sw_tb(
            *(torch.from_numpy(a).to(device) for a in (q, w, qlens)), sc)
        packed, emits = tb.walk(bits, score, qend, lane)
        score = score.cpu().numpy()
        _, _, _, qstart, l_fin, cigars = tb.finalize_extend(
            packed.cpu().numpy(), emits.cpu().numpy())
        for r, ji in enumerate(jidx):
            ci, m, b = jobs[ji]
            if score[r] < 0.3 * 2 * min(len(m), len(b)):
                continue
            cigar = cigars[r]
            base_votes, del_votes, ins, nm = piles[ci]
            qi = int(qstart[r])
            ri = qi + int(l_fin[r]) - 128        # backbone coordinate
            mc = encode(m)
            Lb = len(b)
            for (n, op) in cigar:
                if op == 'M':
                    for t in range(n):
                        if 0 <= ri + t < Lb and mc[qi + t] < 4:
                            base_votes[ri + t, mc[qi + t]] += 1
                    qi += n
                    ri += n
                elif op == 'I':
                    if 0 <= ri < Lb:
                        ins.setdefault(ri, []).append(
                            decode(mc[qi:qi + n]))
                    qi += n
                elif op == 'D':
                    for t in range(n):
                        if 0 <= ri + t < Lb:
                            del_votes[ri + t] += 1
                    ri += n
            piles[ci] = (base_votes, del_votes, ins, nm + 1)

    out = []
    for ci, backbone in enumerate(backbones):
        if not backbone:
            out.append('')
            continue
        base_votes, del_votes, ins, nm = piles[ci]
        bc = encode(backbone)
        Lb = len(bc)
        votes = base_votes.copy()
        for i in range(Lb):
            if bc[i] < 4:
                votes[i, bc[i]] += 1             # backbone's own vote
        best = votes.argmax(axis=1)
        best_n = votes.max(axis=1)
        keep = best_n >= del_votes                # deletion majority drops
        parts = []
        half = nm / 2.0
        for i in range(Lb):
            if i in ins and len(ins[i]) > half:
                parts.append(Counter(ins[i]).most_common(1)[0][0])
            if keep[i] and votes[i].sum() > 0:
                parts.append('ACGT'[best[i]])
        out.append(''.join(parts))
    return out


# ---------------------------------------------------------------------------
# Engine 'poa': column-merged partial-order consensus
# ---------------------------------------------------------------------------

_SUBST = np.full((4, 4), -3.0, np.float32)
np.fill_diagonal(_SUBST, 2.0)

PROFILE_OFFSET = 32      # profile start lane: band covers j-i in [-32, +95]


class _ProfileGraph:
    """Column-merged POA graph: per-column base counts + span counts.

    ``counts[c, b]`` = reads voting base b at column c; ``spans[c]`` =
    reads whose alignment spans column c (gap votes = spans - support).
    Inserting a read's extra bases opens new columns (the partial order)."""

    __slots__ = ('counts', 'spans')

    def __init__(self, backbone_codes: np.ndarray):
        L = len(backbone_codes)
        self.counts = np.zeros((L, 4), np.int32)
        ok = backbone_codes < 4
        self.counts[np.arange(L)[ok], backbone_codes[ok]] = 1
        self.spans = np.ones(L, np.int32)

    def planes(self, Lq: int, match: float, mismatch: float, ext: float):
        """Packed int8 x 4 score plane + cumulative deletion-cost plane for
        a read of padded length Lq (width Lq + 256; profile columns occupy
        [P, P + Lg_eff)).  P = 32: the band at query row i covers profile
        columns j - i in [-32, +95], leaning toward positive drift because
        minority insertions grow the profile over the rounds."""
        P = PROFILE_OFFSET
        W = Lq + 256
        Lg_eff = min(len(self.spans), W - P)
        counts = self.counts[:Lg_eff].astype(np.float32)
        support = counts.sum(axis=1)
        denom = np.maximum(support, 1.0)
        sc = counts @ _SUBST / denom[:, None]          # (Lg_eff, 4)
        q8 = np.clip(np.rint(sc * pa.SCALE), -127, 127).astype(np.int64)
        q8[support == 0] = pa.PAD_BYTE
        b = (q8 & 0xFF).astype(np.uint32)
        packed = (b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
                  | (b[:, 3] << 24)).astype(np.uint32)
        sp = np.full(W, np.uint32(0x80808080), np.uint32)
        sp[P:P + Lg_eff] = packed
        cov = np.clip(support / np.maximum(self.spans[:Lg_eff], 1),
                      1.0 / 16.0, 1.0)
        ext_c = np.full(W, ext, np.float32)
        ext_c[P:P + Lg_eff] = ext * cov
        g = np.cumsum(ext_c, dtype=np.float64).astype(np.float32)
        return sp.view(np.int32), g

    def update(self, read_codes: np.ndarray, qstart: int, col_start: int,
               cigar: list[tuple[int, str]]):
        """Accumulate one traceback path: base counts on M columns, spans
        over the covered range, new columns for insertions."""
        Lg = len(self.spans)
        qi, ri = qstart, col_start
        inserts = []                       # (column, codes) before column
        for n, op in cigar:
            if op == 'M':
                lo = max(ri, 0)
                hi = min(ri + n, Lg)
                if hi > lo:
                    qseg = read_codes[qi + (lo - ri):qi + (hi - ri)]
                    cols = np.arange(lo, hi)
                    ok = qseg < 4
                    np.add.at(self.counts, (cols[ok], qseg[ok]), 1)
                qi += n
                ri += n
            elif op == 'I':
                if 0 <= ri <= Lg:
                    inserts.append((ri, read_codes[qi:qi + n]))
                qi += n
            elif op == 'D':
                ri += n
        lo = max(col_start, 0)
        hi = min(ri, Lg)
        if hi > lo:
            self.spans[lo:hi] += 1
        if inserts:
            self._splice(inserts)

    def _splice(self, inserts):
        Lg = len(self.spans)
        counts_parts, spans_parts = [], []
        prev = 0
        for (p, codes) in inserts:
            counts_parts.append(self.counts[prev:p])
            spans_parts.append(self.spans[prev:p])
            n = len(codes)
            cn = np.zeros((n, 4), np.int32)
            ok = codes < 4
            cn[np.arange(n)[ok], codes[ok]] = 1
            sn = np.full(n, self.spans[min(max(p, 0), Lg - 1)]
                         if Lg else 1, np.int32)
            counts_parts.append(cn)
            spans_parts.append(sn)
            prev = p
        counts_parts.append(self.counts[prev:])
        spans_parts.append(self.spans[prev:])
        self.counts = np.concatenate(counts_parts, axis=0)
        self.spans = np.concatenate(spans_parts, axis=0)

    def consensus(self) -> str:
        support = self.counts.sum(axis=1)
        keep = (2 * support > self.spans) & (support > 0)
        best = self.counts.argmax(axis=1)
        return decode(best[keep].astype(np.uint8))


def consensus_sequences_poa(clusters: list[list[str]], cfg: ConsensusConfig,
                            device: torch.device) -> list[str]:
    """Round r aligns every cluster's r-th member against that cluster's
    current profile graph, one call per length bucket."""
    sc = ScoringConfig(gap_open_is_first_base=False)
    graphs: list[_ProfileGraph | None] = []
    rests: list[list[np.ndarray]] = []
    for members in clusters:
        members = [m for m in members if m]
        if not members:
            graphs.append(None)
            rests.append([])
            continue
        graphs.append(_ProfileGraph(encode(members[0])[:cfg.max_length]))
        rest = members[1:]
        cap = cfg.max_reads_per_cluster - 1
        if len(rest) > cap:
            idx = np.linspace(0, len(rest) - 1, cap).astype(int)
            rest = [rest[i] for i in idx]
        rests.append([encode(m)[:cfg.max_length] for m in rest])

    n_rounds = max((len(r) for r in rests), default=0)
    for r in range(n_rounds):
        jobs = [(ci, rests[ci][r]) for ci in range(len(clusters))
                if len(rests[ci]) > r and graphs[ci] is not None]
        by_bucket: dict[int, list[int]] = {}
        for ji, (ci, codes) in enumerate(jobs):
            by_bucket.setdefault(_pad128(max(len(codes), 1)),
                                 []).append(ji)
        for Lq, jidx in sorted(by_bucket.items()):
            N = len(jidx)
            q = np.full((N, Lq), 4, np.uint8)
            sp = np.empty((N, Lq + 256), np.int32)
            g = np.empty((N, Lq + 256), np.float32)
            qlens = np.zeros(N, np.int32)
            for row, ji in enumerate(jidx):
                ci, codes = jobs[ji]
                q[row, :len(codes)] = codes
                qlens[row] = len(codes)
                sp[row], g[row] = graphs[ci].planes(
                    Lq, float(sc.match), float(sc.mismatch),
                    float(sc.gap_extend))
            score, qend, lane, qstart, l_fin, cigars = pa.profile_align_walk(
                *(torch.from_numpy(a).to(device) for a in (q, sp, g)), qlens,
                sc)
            for row, ji in enumerate(jidx):
                ci, codes = jobs[ji]
                Lg = len(graphs[ci].spans)
                if score[row] < 0.3 * 2 * min(len(codes), Lg):
                    continue
                col_start = (int(qstart[row]) + int(l_fin[row])
                             - PROFILE_OFFSET)
                graphs[ci].update(codes, int(qstart[row]), col_start,
                                  cigars[row])

    return ['' if gph is None else gph.consensus() for gph in graphs]
