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

Three paths hold the entries, chosen by the stream's size before the build
(``build_entries``, as fslr_tpu's):

  * up to ``spill_min_encounters``: **in-HBM**, one accumulator and one
    traversal-ordered entry set on the device (:class:`EntrySet`);
  * above that, up to ``SPILL_DIRECT_MIN``: **sharded**, the pairs in
    pk-range buckets on the device, gated bucket by bucket and exchanged
    into query-range buckets (:class:`ShardedEntrySet`); only 12 bytes a
    pair stay resident, the transients are one bucket's;
  * above ``SPILL_DIRECT_MIN``, or where the sharded build overflows a
    bucket or runs out of device memory: the **spill**, which keeps the
    slices' reductions in host memory in pk-range buckets, deduplicates
    and gates them with the same functions on CPU tensors and orders them
    with numpy (``_build_entries_spill``); it still enumerates on the
    device.

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
import gc
import sys

import numpy as np
import torch

from fslr_tpu_torch.instrument import span

_SK_FLAG = 1 << 30
_SK_BIG = 2**31 - 1
# pair states gated or ordered per device call (bounds the int64 and
# float64 temporaries to a few GB whatever the pair count)
_GATE_CHUNK = 1 << 26
# the spill path's pk-range buckets hold the reductions of at most this
# many encounters each (bounds phase 2's host temporaries)
_PHASE2_CAP = 1 << 26
# the sharded path's buckets: as many pk-range buckets (a power of two, at
# most 4096) as keep the encounters a bucket at or below _BUCKET_TARGET,
# and as many query-range buckets as keep the entries a bucket there; a
# bucket past _BUCKET_CAP pairs (key skew) raises _ShardOverflow
_BUCKET_TARGET = 1 << 25
_BUCKET_CAP = 1 << 26
# Streams above this many encounters go to the spill without a sharded
# attempt.  The sharded path keeps 12 bytes a pair resident (pk int64 +
# sk int32, then key int64 + other read int32), plus one slice's and one
# bucket's transients: its peak was 10.71 GB at 6.99e8 pairs, 17.30 GB at
# 1.22e9 and 45.93 GB at 3.49e9 (15.3, 14.1 and 13.1 B a pair; 12 B a
# pair + 2-4 GB), through query_graph on tools/synth's cluster-scale
# data (chip_smoke.cluster_paths on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit).  A pair is met at least twice (once from each
# read), so 2^33 encounters are at most 2^32 pairs: 51.5 GB + ~4 GB,
# which leaves ~24 GB of an 80 GB card to the stages' other tensors.
SPILL_DIRECT_MIN = 1 << 33
# slice results merged into an accumulator at a time
_KMAX = 3


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


class _Acc:
    """Slice results merged into one deduplicated accumulator, at most
    _KMAX at a time (or once ``merge_cap`` encounters are held), so the
    device holds the accumulator and one merge's inputs and outputs."""

    def __init__(self, merge_cap: int):
        self.merge_cap = merge_cap
        self.parts: list = []
        self.held = 0
        self.acc = None

    def add(self, pk, sk, n: int):
        self.parts.append((pk, sk))
        self.held += n
        if self.held >= self.merge_cap or len(self.parts) >= _KMAX:
            self.merge()

    def merge(self):
        while self.parts:
            group = [self.parts.pop(0)
                     for _ in range(min(_KMAX, len(self.parts)))]
            if self.acc is not None:
                group.insert(0, self.acc)
            self.acc = None
            if len(group) == 1:
                self.acc = group[0]     # one slice result is reduced
            else:
                state = [torch.cat([p for p, _ in group]),
                         torch.cat([s for _, s in group])]
                group.clear()
                self.acc = _min_by_key(state)
        self.held = 0

    def size(self) -> int:
        return 0 if self.acc is None else int(self.acc[0].numel())

    def take(self) -> list:
        """The merged [pk, sk] (empty when nothing was added); the
        accumulator lets go of it."""
        self.merge()
        state = [] if self.acc is None else list(self.acc)
        self.acc = None
        return state


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


def _gate_compact(state: list, R: int, trav_scale: int, gate_args):
    """state = [pk, sk] (emptied) -> the gated pairs as [traversal key
    int64, other read int32], in pk order: fslr_tpu's ``_gate_fn`` and
    ``_gate_compact_fn``, in chunks of _GATE_CHUNK pairs."""
    pk, sk = state
    state.clear()
    tv_parts, eo_parts = [], []
    for c0 in range(0, pk.numel(), _GATE_CHUNK):
        a, b, rest = _split_pair(pk[c0:c0 + _GATE_CHUNK],
                                 sk[c0:c0 + _GATE_CHUNK], R)
        g = _gate(a, b, *gate_args)
        tv_parts.append((a * trav_scale + rest)[g])
        eo_parts.append(b[g].to(torch.int32))
        del a, b, rest, g
    del pk, sk
    return [torch.cat(tv_parts), torch.cat(eo_parts)]


def _traversal_order(state: list):
    """state = [tv, eo] (emptied) -> (key, other read) sorted by the
    traversal key (keys are unique); tv frees before eo is gathered."""
    tv, eo = state
    state.clear()
    key, order = torch.sort(tv)
    del tv
    return key, eo[order]


def _query_bounds(key, q_lo: int, q_hi: int, trav_scale: int) -> np.ndarray:
    """For each query q in [q_lo, q_hi): the number of the sorted keys
    that belong to queries below q."""
    q0 = torch.arange(q_lo, q_hi, dtype=torch.int64, device=key.device) \
        * trav_scale
    return torch.searchsorted(key, q0).cpu().numpy().astype(np.int64)


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


class ShardedEntrySet:
    """The sharded path's entries: per query-range bucket, the traversal
    keys (int64) and other reads (int32) on the device, sorted.  The
    global entry order is the buckets' concatenation (``offsets[i]`` is
    bucket i's first global index) and a query never spans two buckets;
    ``bounds`` (R + 1,) are the global per-query ranges."""

    def __init__(self, buckets: list, offsets: np.ndarray,
                 bounds: np.ndarray, E: int):
        self._buckets = buckets
        self._offsets = offsets
        self.bounds = bounds
        self.E = E

    def device_buckets(self):
        """[(key, eo, global base, n entries)] of the non-empty buckets,
        in global traversal order (ops/capwalk.resolve_device)."""
        return [(key, eo, int(self._offsets[i]), int(key.numel()))
                for i, (key, eo) in enumerate(self._buckets)
                if key.numel()]


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


class _ShardOverflow(Exception):
    """A bucket of the sharded build passed _BUCKET_CAP pairs (key skew);
    build_entries falls back to the spill."""


def _n_buckets(n: int) -> int:
    """The buckets (a power of two up to 4096) that keep n / B at or
    below _BUCKET_TARGET."""
    B = 1
    while B < 4096 and n // B > _BUCKET_TARGET:
        B *= 2
    return B


def build_entries(jobs: list[ChromJob], R: int, max_itv: int, max_nc: int,
                  qlen2: np.ndarray, naln: np.ndarray, qlen_thresh: float,
                  naln_thresh: float, slice_cap: int, merge_cap: int,
                  spill_min_encounters: int, device: torch.device,
                  stats: dict | None = None):
    """Enumerate -> per-pair first encounter -> gate -> traversal order.

    qlen_thresh / naln_thresh are ``1 - qlen_diff`` and ``1 -
    n_alignment_diff`` (Python floats).  The path follows fslr_tpu's
    dispatch: streams of at most ``spill_min_encounters`` encounters stay
    in-HBM (an :class:`EntrySet`), streams above ``SPILL_DIRECT_MIN``
    (read at call time) go to the spill (a
    :class:`HostEntrySet`), and those between take the sharded path (a
    :class:`ShardedEntrySet`), which falls back to the spill when a bucket
    overflows or the card runs out of memory; all hold the same entries.
    ``stats`` receives the path (``'in-HBM'``, ``'sharded'`` or
    ``'spill'``), the reason of a fallback (``'fallback'``) and the
    encounter, pair and entry counts.  The phases are spans
    (``instrument.span``): ``enum_merge`` (enumeration and the merge of
    the slices' reductions) and ``gate_order`` (the gate and the
    traversal order).
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
    args = (jobs, R, max_itv, max_nc, qlen2, naln, qlen_thresh, naln_thresh,
            slice_cap)
    if total_enc > SPILL_DIRECT_MIN:
        print(f'encounter build: {total_enc} encounters, host-spill path',
              file=sys.stderr)
        stats['path'] = 'spill'
        return _spill_with_retry(*args, device, stats)
    if total_enc <= spill_min_encounters:
        stats['path'] = 'in-HBM'
        return _build_entries_dev(*args, merge_cap, device, stats)
    # the fallback runs outside the except blocks: a live exception pins
    # its traceback's frames, and with them the failed build's tensors
    stats['path'] = 'sharded'
    try:
        return _build_entries_sharded(*args, merge_cap, device, stats)
    except _ShardOverflow as e:
        why = f'overflow ({e})'
    except torch.cuda.OutOfMemoryError:
        why = 'exhausted device memory'
    print(f'WARNING: sharded encounter build {why}; falling back to '
          'host-spill path', file=sys.stderr)
    stats['path'] = 'spill'
    stats['fallback'] = why
    _release(device)
    return _spill_with_retry(*args, device, stats)


def _release(device: torch.device):
    """Free what a failed build left: its tensors, then the allocator's
    cached blocks."""
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


def _spill_with_retry(jobs, R, max_itv, max_nc, qlen2, naln, qlen_thresh,
                      naln_thresh, slice_cap, device, stats):
    """The spill with fslr_tpu's degradation ladder: where the card runs
    out of memory, retry with 4x and then 16x smaller enumeration slices
    and pk buckets (smaller device transients, more round trips).  The
    divisor that completed is ``stats['spill_div']``."""
    for div in (1, 4, 16):
        try:
            stats['spill_div'] = div
            return _build_entries_spill(
                jobs, R, max_itv, max_nc, qlen2, naln, qlen_thresh,
                naln_thresh, max(slice_cap // div, min(slice_cap, 1 << 20)),
                device, stats, phase2_cap=max(_PHASE2_CAP // div, 1 << 20))
        except torch.cuda.OutOfMemoryError:
            if div == 16:
                raise
        print(f'WARNING: host-spill build exhausted device memory at '
              f'slice_cap/{div}; retrying at slice_cap/{div * 4}',
              file=sys.stderr)
        _release(device)


def _build_entries_dev(jobs, R, max_itv, max_nc, qlen2, naln, qlen_thresh,
                       naln_thresh, slice_cap, merge_cap, device, stats):
    """The in-HBM path (fslr_tpu's ``_build_entries_x64``): slice results
    merge into one deduplicated accumulator (:class:`_Acc`)."""
    with span('enum_merge'):
        acc = _Acc(merge_cap)
        for job in jobs:
            for pk_u, sk_u, n in _enum_job_slices(job, slice_cap, R,
                                                  max_nc, device):
                acc.add(pk_u, sk_u, n)
                del pk_u, sk_u
        state = acc.take()
    U = int(state[0].numel()) if state else 0
    stats['pairs'] = U
    if U == 0:
        stats['entries'] = 0
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return EntrySet(z, z.to(torch.int32), np.zeros(R + 1, np.int64), 0)
    with span('gate_order'):
        trav_scale = max_itv * max_nc
        key, eo = _traversal_order(_gate_compact(
            state, R, trav_scale, _gate_args(qlen2, naln, qlen_thresh,
                                             naln_thresh, device)))
        bounds = _query_bounds(key, 0, R + 1, trav_scale)
    E = int(key.numel())
    stats['entries'] = E
    return EntrySet(key, eo, bounds, E)


def _gate_args(qlen2, naln, qlen_thresh, naln_thresh, device):
    return (torch.as_tensor(np.asarray(qlen2, np.float64), device=device),
            torch.as_tensor(np.asarray(naln, np.float64), device=device),
            qlen_thresh, naln_thresh)


def _share(a, b, lo: int, hi: int):
    """(a[lo:hi], b[lo:hi]): the arrays themselves when the range is all
    of them, else copies, so that the arrays free once they are cut (a
    view would keep each one whole until its bucket merges)."""
    if hi - lo == a.numel():
        return a, b
    return a[lo:hi].clone(), b[lo:hi].clone()


def _build_entries_sharded(jobs, R, max_itv, max_nc, qlen2, naln,
                           qlen_thresh, naln_thresh, slice_cap, merge_cap,
                           device, stats) -> ShardedEntrySet:
    """The sharded path (fslr_tpu's ``_build_entries_sharded``), in three
    phases on the device:

      1. each slice's pk-sorted reduction is cut at B pk-range bounds
         (``torch.searchsorted``) and each share, copied out, merges
         into its bucket's accumulator (:class:`_Acc`);
      2. each pk bucket is gated and compacted to (traversal key, other
         read), freeing its accumulator;
      3. each gated bucket is sorted by key and cut into B2 query-range
         buckets, then freed; each query bucket is sorted, and its
         per-query bounds come from ``searchsorted`` on its keys.

    Raises _ShardOverflow when a bucket passes _BUCKET_CAP pairs.
    """
    with span('enum_merge'):
        trav_scale = max_itv * max_nc
        B = _n_buckets(sum(int(j.ccum[-1]) for j in jobs))
        W = (R * R) // B + 1
        pk_bounds = torch.arange(1, B, dtype=torch.int64, device=device) * W
        accs = [_Acc(merge_cap) for _ in range(B)]
        stats['pk_buckets'] = B

        # ---- phase 1: enumerate slices, merge each share into its bucket --
        for job in jobs:
            for pk_u, sk_u, _ in _enum_job_slices(job, slice_cap, R, max_nc,
                                                  device):
                c = int(pk_u.numel())
                cuts = [0, *torch.searchsorted(pk_u, pk_bounds).tolist(), c]
                for acc, lo, hi in zip(accs, cuts[:-1], cuts[1:]):
                    if hi > lo:
                        acc.add(*_share(pk_u, sk_u, lo, hi), hi - lo)
                        if acc.size() > _BUCKET_CAP:
                            raise _ShardOverflow(acc.size())
                del pk_u, sk_u
        for acc in accs:
            acc.merge()
            if acc.size() > _BUCKET_CAP:
                raise _ShardOverflow(acc.size())
        U = sum(acc.size() for acc in accs)
    stats['pairs'] = U

    with span('gate_order'):
        # ---- phase 2: gate and compact each pk bucket ---------------------
        gate_args = _gate_args(qlen2, naln, qlen_thresh, naln_thresh, device)
        gated: list = []
        for b in range(B):
            state = accs[b].take()
            accs[b] = None
            if not state:
                continue
            pair = _gate_compact(state, R, trav_scale, gate_args)
            if pair[0].numel():
                gated.append(pair)
            del pair

        # ---- phase 3: exchange into query-range buckets, order -------------
        E = sum(int(tv.numel()) for tv, _ in gated)
        B2 = _n_buckets(E)
        qw = (R + B2) // B2             # query ids a bucket; B2 * qw > R
        tv_bounds = torch.arange(1, B2, dtype=torch.int64, device=device) \
            * (qw * trav_scale)
        pieces: list = [[] for _ in range(B2)]
        while gated:
            key, eo = _traversal_order(gated.pop(0))
            n = int(key.numel())
            cuts = [0, *torch.searchsorted(key, tv_bounds).tolist(), n]
            for j, lo, hi in zip(range(B2), cuts[:-1], cuts[1:]):
                if hi > lo:
                    pieces[j].append(_share(key, eo, lo, hi))
            del key, eo
        buckets: list = []
        offsets = np.zeros(B2 + 1, np.int64)
        bounds = np.zeros(R + 1, np.int64)
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        for j in range(B2):
            parts, pieces[j] = pieces[j], None
            if sum(int(k.numel()) for k, _ in parts) > _BUCKET_CAP:
                raise _ShardOverflow(sum(int(k.numel()) for k, _ in parts))
            if parts:
                state = [torch.cat([k for k, _ in parts]),
                         torch.cat([e for _, e in parts])]
                parts.clear()
                key, eo = _traversal_order(state)
            else:
                key, eo = empty, empty.to(torch.int32)
            q_lo, q_hi = j * qw, min((j + 1) * qw, R + 1)
            if q_lo < q_hi:
                bounds[q_lo:q_hi] = offsets[j] + _query_bounds(key, q_lo, q_hi,
                                                               trav_scale)
            buckets.append((key, eo))
            offsets[j + 1] = offsets[j] + key.numel()
            del key, eo
    stats['query_buckets'] = B2
    stats['entries'] = E
    return ShardedEntrySet(buckets, offsets, bounds, E)


def _build_entries_spill(jobs, R, max_itv, max_nc, qlen2, naln, qlen_thresh,
                         naln_thresh, slice_cap, device, stats,
                         phase2_cap: int = _PHASE2_CAP) -> HostEntrySet:
    """Enumerate on the device, keep the slices' reductions in host memory
    in pk-range buckets, then deduplicate and gate each bucket with the
    in-HBM path's own functions on CPU tensors, and order the gated
    entries one query range at a time with numpy (fslr_tpu's
    ``_build_entries_spill``).  Its size is bounded by host memory, not by
    the card's."""
    with span('enum_merge'):
        trav_scale = max_itv * max_nc
        total_enc = sum(int(j.ccum[-1]) for j in jobs)
        # pk-range buckets of at most phase2_cap encounters' reductions each
        B = 1
        while B < 4096 and total_enc // B > phase2_cap:
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

    with span('gate_order'):
        # ---- phase 2: per bucket, host dedup + float64 gate ---------------
        # gated entries land in query-range buckets, so the traversal sort of
        # phase 3 runs one bounded range at a time
        gate_args = _gate_args(qlen2, naln, qlen_thresh, naln_thresh,
                               torch.device('cpu'))
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
    if E == 0:
        z = np.zeros(0, np.int32)
        return HostEntrySet(z, z, np.zeros(R + 1, np.int64), 0)
    bounds = np.zeros(R + 1, np.int64)
    np.cumsum(counts_q, out=bounds[1:])
    return HostEntrySet(np.concatenate(ei_parts), np.concatenate(eo_parts),
                        bounds, E)
