"""Encounter enumeration for breakpoint clustering at scale, in torch ops.

Counterpart of ``fslr_tpu/ops/encounters.py``.  The reference's overlap
walk visits, for every query read in first-seen order, each of its
intervals and every interval that overlaps it (an "encounter"); a pair of
reads counts once, at its first encounter.  The encounter stream grows
with the square of a breakpoint group's size (7.0e8 encounters for 10^6
reads in groups of 700), so here it is never built on the host:

  1. a slice of a chromosome's encounter range [g0, g0 + n) is expanded on
     ``device``: the query interval of encounter g is the last interval
     whose prefix count ``ccum`` is <= g (``torch.searchsorted``), the
     neighbour its window start plus the offset;
  2. each slice reduces to one entry a read pair -- the pair key
     pk = min*R + max (int64) and the minimum of its 31-bit traversal
     state sk -- by one stable sort of pk and a segment minimum
     (``scatter_reduce`` with ``amin``);
  3. slice results merge into one accumulator, sorted by pk, with the same
     reduction; the qlen2 / n_alignments gate runs in float64 on the
     device (the reference's own arithmetic, fslr cluster.py:178-183),
     and the gated entries are sorted into traversal order and stay on
     the device for ops/capwalk.resolve_device.

Above ``spill_min_encounters`` the spill path keeps the slices'
reductions in host memory in pk-range buckets, deduplicates and gates them
with the same functions on CPU tensors and orders them with numpy
(``_build_entries_spill``); it still enumerates on the device.  The path is chosen by size before the build.  fslr_tpu also
has a sharded device path between the two (pk-range buckets on the device,
for the TPU's 2 GiB limit on one buffer); the card has no such limit and
the port goes straight from the one to the other (ROADMAP.md).

Pair state (12 bytes): pk, and sk = side_flag * 2^30 + interval_rank *
max_nc + neighbour position, side_flag = 1 when the query read is the
larger id.  Within a pk group, sk orders as the traversal key does (the
query read first, then its interval rank, then the neighbour's position),
so the minimum sk is the pair's first encounter, and the traversal key
tv = (query * max_itv + rank) * max_nc + position rebuilds from it.
Requires max_itv * max_nc < 2^30 (stages/cluster.py keeps larger
datasets on its host path).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

_SK_FLAG = 1 << 30
_SK_BIG = 2**31 - 1
# pair states gated or ordered per device call (bounds the int64 and
# float64 temporaries to a few GB whatever the pair count)
_GATE_CHUNK = 1 << 26
# the spill path's pk-range buckets hold the reductions of at most this
# many encounters each (bounds phase 2's host temporaries)
_PHASE2_CAP = 1 << 26


@dataclasses.dataclass
class ChromJob:
    """One chromosome's interval join, host arrays sorted by start (the
    arrays stages/cluster.query_graph builds): ``lo`` the first candidate
    neighbour of each interval, ``ccum`` (NC + 1,) the prefix sums of the
    neighbour counts, ``rid`` the read id and ``irk`` the interval's rank
    within its read."""
    starts: np.ndarray
    ends: np.ndarray
    lo: np.ndarray
    ccum: np.ndarray
    rid: np.ndarray
    irk: np.ndarray


def _min_by_key(state: list):
    """state = [pk, sk] -> (unique pk ascending, minimum sk of each): one
    stable sort of pk and a segment minimum.  ``state`` is emptied, so
    each input frees as soon as it is consumed."""
    pk, sk = state
    state.clear()
    if pk.numel() == 0:
        return pk, sk
    pk_s, order = torch.sort(pk, stable=True)
    del pk
    sk_s = sk[order]
    del order, sk
    first = torch.ones_like(pk_s, dtype=torch.bool)
    first[1:] = pk_s[1:] != pk_s[:-1]
    seg = torch.cumsum(first, 0) - 1
    pk_u = pk_s[first]
    del pk_s, first
    sk_u = torch.full((pk_u.numel(),), _SK_BIG, dtype=torch.int32,
                      device=pk_u.device)
    sk_u.scatter_reduce_(0, seg, sk_s, 'amin')
    return pk_u, sk_u


def _enum_reduce(tabs, g0: int, n: int, R: int, max_nc: int):
    """Encounters [g0, g0 + n) of one chromosome job -> (pk_u, sk_u):
    fslr_tpu's ``_enum_reduce_fn``, whose segment fill by scatter and
    cumsum becomes a searchsorted of the encounter index in ``ccum`` and
    whose mask-and-sort compaction becomes boolean indexing."""
    ccum, lo, starts, ends, rid, irk = tabs
    g = torch.arange(g0, g0 + n, dtype=torch.int64, device=ccum.device)
    qx = torch.searchsorted(ccum, g, right=True) - 1
    nx = lo[qx] + (g - ccum[qx])
    del g
    a = rid[qx]
    b = rid[nx]
    keep = (ends[nx] >= starts[qx]) & (a != b)
    a, b, qx, nx = a[keep], b[keep], qx[keep], nx[keep]
    del keep
    state = [torch.minimum(a, b) * R + torch.maximum(a, b),
             ((a > b).to(torch.int64) * _SK_FLAG + irk[qx] * max_nc + nx)
             .to(torch.int32)]
    del a, b, qx, nx
    return _min_by_key(state)


def _enum_job_slices(job: ChromJob, slice_cap: int, R: int, max_nc: int,
                     device: torch.device):
    """Yield (pk_u, sk_u, n_encounters) per slice of one chromosome job
    (shared by the in-HBM and spill paths)."""
    total = int(job.ccum[-1])
    if total == 0:
        return
    tabs = tuple(torch.as_tensor(np.asarray(x, np.int64), device=device)
                 for x in (job.ccum, job.lo, job.starts, job.ends, job.rid,
                           job.irk))
    g0 = 0
    while g0 < total:
        n = min(total - g0, slice_cap)
        yield (*_enum_reduce(tabs, g0, n, R, max_nc), n)
        g0 += n


def _split_pair(pk, sk, R: int):
    """(a = query read, b = other read, rest) from the pair state; pk and
    sk are non-negative here (no sentinel), so // and % are exact."""
    p_lo = pk // R
    p_hi = pk - p_lo * R
    flag = (sk >> 30).to(torch.bool)
    rest = (sk & (_SK_FLAG - 1)).to(torch.int64)
    return (torch.where(flag, p_hi, p_lo), torch.where(flag, p_lo, p_hi),
            rest)


def _gate(a, b, qlen2_d, naln_d, qlen_thresh: float, naln_thresh: float):
    """The reference's pair gate, float64 on the device: the pair (a, b)
    passes when min/max of qlen2 >= qlen_thresh or min/max of
    n_alignments >= naln_thresh.  fslr_tpu's ``_apply_gate`` reaches this
    value with a float32 band and a float64 host recheck of the borderline
    entries (``_border_index_fn``), for want of float64 on the TPU."""
    q1, q2 = qlen2_d[a], qlen2_d[b]
    n1, n2 = naln_d[a], naln_d[b]
    r_q = torch.minimum(q1, q2) / torch.clamp_min(torch.maximum(q1, q2),
                                                  1e-12)
    r_n = torch.minimum(n1, n2) / torch.maximum(n1, n2)
    return (r_q >= qlen_thresh) | (r_n >= naln_thresh)


def _order(acc: list, R: int, trav_scale: int, gate_args):
    """acc = [pk, sk] (emptied) -> the gated entries in traversal order:
    (key = traversal key int64, other read int32, bounds (R + 1,) numpy).
    fslr_tpu's ``_gate_fn`` and ``_order_fn`` in one pass of chunks; the
    run-jump array ``_order_fn`` also builds is not kept (resolve_device
    finds the run starts from the keys)."""
    pk, sk = acc
    acc.clear()
    tv_parts, eo_parts = [], []
    for c0 in range(0, pk.numel(), _GATE_CHUNK):
        a, b, rest = _split_pair(pk[c0:c0 + _GATE_CHUNK],
                                 sk[c0:c0 + _GATE_CHUNK], R)
        g = _gate(a, b, *gate_args)
        tv_parts.append((a * trav_scale + rest)[g])
        eo_parts.append(b[g].to(torch.int32))
        del a, b, rest, g
    del pk, sk
    tv = torch.cat(tv_parts)
    eo = torch.cat(eo_parts)
    del tv_parts, eo_parts
    key, order = torch.sort(tv)           # traversal keys are unique
    del tv
    eo = eo[order]
    del order
    q0 = torch.arange(R + 1, dtype=torch.int64, device=key.device) \
        * trav_scale
    bounds = torch.searchsorted(key, q0).cpu().numpy().astype(np.int64)
    return key, eo, bounds


class EntrySet:
    """Gated, traversal-ordered pair entries on the device: the traversal
    key (int64) and the other read (int32).  ``bounds[q]:bounds[q + 1]``
    is query q's range; the interval rank and the run starts derive from
    the keys."""

    def __init__(self, key, eo, bounds: np.ndarray, E: int):
        self._key, self._eo = key, eo
        self.bounds = bounds
        self.E = E

    def device_buckets(self):
        """[(key, eo, global base, n entries)] for
        ops/capwalk.resolve_device: one bucket here."""
        return [(self._key, self._eo, 0, self.E)]


@dataclasses.dataclass
class HostEntrySet:
    """The spill path's entries, in host memory: the interval rank ``ei``
    and the other read ``eo`` (int32) in traversal order, and the
    per-query ranges ``bounds`` (consumed by
    capwalk.value_and_replay_host)."""
    ei: np.ndarray
    eo: np.ndarray
    bounds: np.ndarray
    E: int


def build_entries(jobs: list[ChromJob], R: int, max_itv: int, max_nc: int,
                  qlen2: np.ndarray, naln: np.ndarray, qlen_thresh: float,
                  naln_thresh: float, slice_cap: int, merge_cap: int,
                  spill_min_encounters: int, device: torch.device,
                  stats: dict | None = None):
    """Enumerate -> per-pair first encounter -> gate -> traversal order.

    qlen_thresh / naln_thresh are ``1 - qlen_diff`` and ``1 -
    n_alignment_diff`` (Python floats).  Streams of more than
    ``spill_min_encounters`` encounters take the spill path (a
    :class:`HostEntrySet`), the others stay on ``device`` (an
    :class:`EntrySet`); both hold the same entries.  ``stats`` receives
    the path, the encounter count, the entry count and each phase's
    seconds (each phase ends in a copy to the host, so its wall time
    holds its device work).
    """
    stats = {} if stats is None else stats
    trav_scale = max_itv * max_nc
    if trav_scale * (R + 1) >= (1 << 62):
        raise ValueError('traversal key overflows int64')
    if trav_scale >= _SK_FLAG:
        raise ValueError('interval-rank state exceeds 2^30 (the caller '
                         'keeps such datasets on its host path)')
    total_enc = sum(int(j.ccum[-1]) for j in jobs)
    stats['encounters'] = total_enc
    if total_enc > spill_min_encounters:
        print(f'encounter build: {total_enc} encounters, host-spill path',
              file=sys.stderr)
        stats['path'] = 'spill'
        return _build_entries_spill(jobs, R, max_itv, max_nc, qlen2, naln,
                                    qlen_thresh, naln_thresh, slice_cap,
                                    device, stats)
    stats['path'] = 'in-HBM'
    return _build_entries_dev(jobs, R, max_itv, max_nc, qlen2, naln,
                              qlen_thresh, naln_thresh, slice_cap,
                              merge_cap, device, stats)


def _build_entries_dev(jobs, R, max_itv, max_nc, qlen2, naln, qlen_thresh,
                       naln_thresh, slice_cap, merge_cap, device, stats):
    """The in-HBM path (fslr_tpu's ``_build_entries_x64``): slice results
    merge into one deduplicated accumulator at most KMAX parts at a time,
    so the device holds the accumulator and one merge's inputs and
    outputs."""
    t0 = time.perf_counter()
    KMAX = 3
    parts: list = []
    held = 0
    acc = None

    def merge_parts():
        nonlocal held, acc
        while parts:
            group = [parts.pop(0) for _ in range(min(KMAX, len(parts)))]
            if acc is not None:
                group.insert(0, acc)
            acc = None
            if len(group) == 1:
                acc = group[0]      # one slice result is already reduced
            else:
                state = [torch.cat([p for p, _ in group]),
                         torch.cat([s for _, s in group])]
                group.clear()
                acc = _min_by_key(state)
        held = 0

    for job in jobs:
        for pk_u, sk_u, n in _enum_job_slices(job, slice_cap, R, max_nc,
                                              device):
            parts.append((pk_u, sk_u))
            del pk_u, sk_u
            held += n
            if held >= merge_cap or len(parts) >= KMAX:
                merge_parts()
    merge_parts()
    U = 0 if acc is None else int(acc[0].numel())
    stats['pairs'] = U
    t1 = time.perf_counter()
    stats['enum_merge_s'] = t1 - t0
    if U == 0:
        stats['entries'] = 0
        stats['gate_order_s'] = 0.0
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return EntrySet(z, z.to(torch.int32), np.zeros(R + 1, np.int64), 0)
    state = list(acc)
    acc = None
    key, eo, bounds = _order(
        state, R, max_itv * max_nc,
        (torch.as_tensor(np.asarray(qlen2, np.float64), device=device),
         torch.as_tensor(np.asarray(naln, np.float64), device=device),
         qlen_thresh, naln_thresh))
    E = int(key.numel())
    stats['entries'] = E
    stats['gate_order_s'] = time.perf_counter() - t1
    return EntrySet(key, eo, bounds, E)


def _build_entries_spill(jobs, R, max_itv, max_nc, qlen2, naln, qlen_thresh,
                         naln_thresh, slice_cap, device,
                         stats) -> HostEntrySet:
    """Enumerate on the device, keep the slices' reductions in host memory
    in pk-range buckets, then deduplicate and gate each bucket with the
    in-HBM path's own functions on CPU tensors, and order the gated
    entries one query range at a time with numpy (fslr_tpu's
    ``_build_entries_spill``).  Its size is bounded by host memory, not by
    the card's."""
    t0 = time.perf_counter()
    trav_scale = max_itv * max_nc
    total_enc = sum(int(j.ccum[-1]) for j in jobs)
    # pk-range buckets of at most _PHASE2_CAP encounters' reductions each
    B = 1
    while B < 4096 and total_enc // B > _PHASE2_CAP:
        B *= 2
    W = (R * R) // B + 1
    bucket_bounds = np.arange(1, B, dtype=np.int64) * W
    host_pk: list[list] = [[] for _ in range(B)]
    host_sk: list[list] = [[] for _ in range(B)]

    # ---- phase 1: enumerate slices on the device, spill per bucket ----
    for job in jobs:
        for pk_u, sk_u, _ in _enum_job_slices(job, slice_cap, R, max_nc,
                                              device):
            c = int(pk_u.numel())
            if c == 0:
                continue
            pk_h = pk_u.cpu().numpy()
            sk_h = sk_u.cpu().numpy()
            del pk_u, sk_u
            cuts = np.concatenate(
                [[0], np.searchsorted(pk_h, bucket_bounds), [c]])
            for b in range(B):
                if cuts[b + 1] > cuts[b]:
                    host_pk[b].append(pk_h[cuts[b]:cuts[b + 1]])
                    host_sk[b].append(sk_h[cuts[b]:cuts[b + 1]])
    t1 = time.perf_counter()
    stats['enum_merge_s'] = t1 - t0

    # ---- phase 2: per bucket, host dedup + float64 gate ---------------
    # gated entries land in query-range buckets, so the traversal sort of
    # phase 3 runs one bounded range at a time
    gate_args = (torch.as_tensor(np.asarray(qlen2, np.float64)),
                 torch.as_tensor(np.asarray(naln, np.float64)),
                 qlen_thresh, naln_thresh)
    NQR = 64
    q_span = max(1, -(-R // NQR))
    range_tv: list[list] = [[] for _ in range(NQR)]
    range_eo: list[list] = [[] for _ in range(NQR)]
    U = 0
    for b in range(B):
        if not host_pk[b]:
            continue
        state = [torch.from_numpy(np.concatenate(host_pk[b])),
                 torch.from_numpy(np.concatenate(host_sk[b]))]
        host_pk[b] = host_sk[b] = None
        pk_u, sk_u = _min_by_key(state)
        U += int(pk_u.numel())
        a, bb, rest = _split_pair(pk_u, sk_u, R)
        del pk_u, sk_u
        ok = _gate(a, bb, *gate_args)
        a_k = a[ok].numpy()
        tv_k = a_k * trav_scale + rest[ok].numpy()
        eo_k = bb[ok].numpy().astype(np.int32)
        del a, bb, rest, ok
        if len(a_k):
            qr_k = a_k // q_span
            ord_q = np.argsort(qr_k, kind='stable')
            cuts = np.searchsorted(qr_k[ord_q], np.arange(NQR + 1))
            tv_s = tv_k[ord_q]
            eo_s_ = eo_k[ord_q]
            del qr_k, ord_q
            for qr in range(NQR):
                if cuts[qr + 1] > cuts[qr]:
                    range_tv[qr].append(tv_s[cuts[qr]:cuts[qr + 1]])
                    range_eo[qr].append(eo_s_[cuts[qr]:cuts[qr + 1]])
            del tv_s, eo_s_
        del a_k, tv_k, eo_k
    stats['pairs'] = U

    # ---- phase 3: per query range, traversal order + bounds -----------
    counts_q = np.zeros(R, np.int64)
    ei_parts: list[np.ndarray] = []
    eo_parts: list[np.ndarray] = []
    E = 0
    for qr in range(NQR):
        if not range_tv[qr]:
            continue
        tv = np.concatenate(range_tv[qr])
        eo_r = np.concatenate(range_eo[qr])
        range_tv[qr] = range_eo[qr] = None
        order = np.argsort(tv, kind='stable')    # tv is unique
        tv = tv[order]
        eo_r = eo_r[order]
        del order
        eq_r = tv // trav_scale
        q_lo = qr * q_span
        hi_q = min(q_lo + q_span, R)        # the last range is shorter
        w = hi_q - q_lo                     # when R % q_span != 0
        counts_q[q_lo:hi_q] += np.bincount(eq_r - q_lo, minlength=w)[:w]
        ei_parts.append(((tv // max_nc) % max_itv).astype(np.int32))
        del tv, eq_r
        eo_parts.append(eo_r)
        E += len(eo_r)
    stats['entries'] = E
    stats['gate_order_s'] = time.perf_counter() - t1
    if E == 0:
        z = np.zeros(0, np.int32)
        return HostEntrySet(z, z, np.zeros(R + 1, np.int64), 0)
    bounds = np.zeros(R + 1, np.int64)
    np.cumsum(counts_q, out=bounds[1:])
    return HostEntrySet(np.concatenate(ei_parts), np.concatenate(eo_parts),
                        bounds, E)
