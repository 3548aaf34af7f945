"""Edge-capped traversal replay: the host part.

Counterpart of the host functions of ``fslr_tpu/ops/capwalk.py``.  The
reference's clustering loop walks each read's encounter entries in
traversal order, emits edges whose greedy Jaccard passes the
per-intersection-count cutoff, and once ``edge_threshold`` edges have been
emitted skips the rest of the current interval's neighbour run on every
valued entry.  An entry's (jaccard, n_intersections) depends only on its
read pair, so over the first-encounter entry stream the emitted set is a
closed form:

  pre-cap    every passing entry whose exclusive pass count < T emits
             (this includes the T-th pass, the cap event);
  cap run    the rest of the run holding the cap event is skipped;
  post-cap   in every later run, the walk steps over unvalued (n == 0)
             entries and tests only the FIRST valued entry, which emits
             iff it passes.

The closed form is exact while no query reaches the cap; once one does,
stages/cluster.py's host path replays the walk exactly over the full
stream (``_exact_capped_walk``).  The scale path (ops/encounters.py) keeps
the closed form, as fslr_tpu's does: :func:`resolve_device` values and
replays entries that stay on the device, :func:`value_and_replay_host`
those of the spill path.  Both replay query-aligned chunks of entries:
the cap is per query, so chunking is exact and bounds the temporaries.

Where a query caps, the closed form tests each pair at its first
encounter, while the reference walk may test it again later (a pair its
cap skipped stays unseen).  fslr_tpu's adversarial sweep
(fslr_tpu/tools/cap_sweep.py: 900 cap-heavy frames forced onto its
device path) found the partition changed on 4 frames (0.44%), each time
by splitting one cluster bridged only by such re-tests;
tests/test_torch_capwalk.py holds the port to fslr_tpu's device path on
those four frames.  The port's own sweep (tools/cap_sweep.py, the scale
path against the exact host walk; PERF.md section 6) found 8 of 2,000
frames (0.40%) on an H100: on seeds 1-900 the same four as fslr_tpu's.
"""

from __future__ import annotations

import numpy as np
import torch

from fslr_tpu_torch.ops import jaccard

# entries valued and replayed per device chunk (query-aligned)
CHUNK = 1 << 22


def replay(passv: np.ndarray, gated: np.ndarray, rc: np.ndarray,
           eq: np.ndarray, bounds: np.ndarray, edge_threshold: int):
    """Emission mask of the edge-capped traversal.

    Args:
      passv: entry passes its jaccard cutoff (implies ``gated``).
      gated: entry was valued with n_intersections != 0.
      rc:    True where a new (query, interval) run starts.
      eq:    querying read per entry (entries sorted by read, runs
             contiguous within a read).
      bounds: (R+1,) entry range per read.
      edge_threshold: the soft edge cap T.
    """
    E = len(passv)
    if E == 0:
        return np.zeros(0, bool)
    T = int(edge_threshold)
    pi = passv.astype(np.int64)
    cum = np.cumsum(pi)
    cum0 = np.concatenate([[0], cum])
    base_cp = np.repeat(cum0[bounds[:-1]], np.diff(bounds))
    cp = cum - base_cp                       # inclusive per-query passes
    capped = (cp - pi) >= T                  # cap reached strictly before
    run_index = np.cumsum(rc) - 1
    capev = passv & (cp == T)                # the T-th pass (<=1 per query)
    R = len(bounds) - 1
    caprun = np.full(R, -1, np.int64)
    caprun[eq[capev]] = run_index[capev]
    in_cap_run = capped & (run_index == caprun[eq])
    gi = gated.astype(np.int64)
    cumg = np.cumsum(gi)
    gex = cumg - gi
    runbase = gex[rc]                        # valued-count at run starts
    first_gated = gated & (gex == runbase[run_index])
    return (passv & ~capped) | (capped & ~in_cap_run & first_gated & passv)


def value_entries(eq, eo, dev_arrays, M, pct, over, host_value,
                  host_arrays):
    """(j64, n_i) for every (eq, eo) pair entry: batched device Jaccard,
    the exact host mirror for reads whose interval lists exceed the table
    width M.  j is float64 (device float32 exactly upcast).

    ``host_arrays`` = (chrom_a, start_a, end_a, size_a, lens_a): pairs
    where BOTH reads have exactly ONE interior interval are valued on the
    host in closed form (j = 1 on a reciprocal-overlap match, else 0;
    jaccard_host's own float64 arithmetic)."""
    E = len(eq)
    j64 = np.zeros(E, np.float64)
    n_i = np.zeros(E, np.int64)
    if E == 0:
        return j64, n_i
    if len(over):
        ovm = np.isin(eq, over) | np.isin(eo, over)
    else:
        ovm = np.zeros(E, bool)
    chrom_a, start_a, end_a, size_a, lens_a = host_arrays
    single = (lens_a[eq] == 1) & (lens_a[eo] == 1) & ~ovm
    rows1 = np.flatnonzero(single)
    if len(rows1):
        a, b = eq[rows1], eo[rows1]
        z1 = size_a[a, 0].astype(np.float64)
        z2 = size_a[b, 0].astype(np.float64)
        ov = np.maximum(
            0, np.minimum(end_a[a, 0], end_a[b, 0])
            - np.maximum(start_a[a, 0], start_a[b, 0])
        ).astype(np.float64)
        with np.errstate(divide='ignore', invalid='ignore'):
            r1 = np.where(z1 > 0, ov / np.where(z1 > 0, z1, 1), 0.0)
            r2 = np.where(z2 > 0, ov / np.where(z2 > 0, z2, 1), 0.0)
        m = ((chrom_a[a, 0] == chrom_a[b, 0]) & (z1 > 0) & (z2 > 0)
             & (np.minimum(r1, r2) >= pct))
        j64[rows1] = m.astype(np.float64)
        n_i[rows1] = m.astype(np.int64)
    dev_rows = np.flatnonzero(~ovm & ~single)
    if len(dev_rows):
        pairs = np.stack([eq[dev_rows], eo[dev_rows]], 1)
        jd, nd = jaccard.jaccard_pairs_indexed(pairs, *dev_arrays, pct, M=M)
        j64[dev_rows] = jd.astype(np.float64)
        n_i[dev_rows] = nd
    if ovm.any():
        rows = np.flatnonzero(ovm)
        jh, nh = host_value(eq[rows], eo[rows])
        j64[rows] = jh
        n_i[rows] = nh
    return j64, n_i


def pass_flags(j64, n_i, cutoffs):
    """(passv, gated) for valued entries: the cutoff of the pair's
    intersection count."""
    cut = np.asarray(cutoffs, np.float64)
    gated = n_i != 0
    passv = gated & (j64 >= cut[np.clip(n_i - 1, 0, len(cut) - 1)])
    return passv, gated


def pass_counts(passv, bounds):
    """Per-query pass counts; a count >= edge_threshold means the query
    caps and the closed-form replay leaves its exactness domain."""
    cum0 = np.concatenate([[0], np.cumsum(passv.astype(np.int64))])
    return cum0[bounds[1:]] - cum0[bounds[:-1]]


def value_and_replay_host(ei, eo, bounds, dev_arrays, M, pct, cutoffs,
                          edge_threshold, over, host_value, host_arrays,
                          chunk=1 << 28):
    """Value every entry (batched device Jaccard; the single-interval
    closed form and the exact host mirror as in :func:`value_entries`) and
    replay the walk in numpy, over query-aligned chunks of about ``chunk``
    entries.  Returns (idx, eo, j) of the emissions in traversal order, j
    float64.  The querying read of each entry is rebuilt per chunk from
    ``bounds``.
    """
    E = len(ei)
    if E == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64)
    eo = np.asarray(eo)
    R = len(bounds) - 1
    out_idx, out_eo, out_j = [], [], []
    q0 = 0
    while q0 < R:
        b0 = int(bounds[q0])
        if b0 >= E:
            break
        # the smallest query range covering >= chunk entries
        q1 = int(np.searchsorted(bounds, b0 + chunk, side='left'))
        q1 = min(max(q1, q0 + 1), R)
        b1 = int(bounds[q1])
        ei_c = ei[b0:b1]
        eo_c = eo[b0:b1]
        cnts = np.diff(bounds[q0:q1 + 1]).astype(np.int64)
        eq_c = np.repeat(np.arange(q0, q1, dtype=np.int64), cnts)
        j64, n_i = value_entries(eq_c, eo_c, dev_arrays, M, pct, over,
                                 host_value, host_arrays)
        passv, gated = pass_flags(j64, n_i, cutoffs)
        rc = np.ones(len(ei_c), bool)
        rc[1:] = (eq_c[1:] != eq_c[:-1]) | (ei_c[1:] != ei_c[:-1])
        lb = (bounds[q0:q1 + 1] - b0).astype(np.int64)
        emit = replay(passv, gated, rc, eq_c - q0, lb, edge_threshold)
        idx_l = np.flatnonzero(emit)
        out_idx.append(idx_l + b0)
        out_eo.append(eo_c[idx_l])
        out_j.append(j64[idx_l])
        q0 = q1
    if not out_idx:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64)
    return (np.concatenate(out_idx), np.concatenate(out_eo),
            np.concatenate(out_j))


# --------------------------------------------------------------------------
# device half: entries never leave the device
# --------------------------------------------------------------------------

def _pack_tables(chrom, start, end, size, lens):
    """Two int64 words a table slot: w1 = start * 2^32 + end, w2 = lens <<
    48 | chrom << 32 | the float32 bits of size; a pair side then gathers
    two words instead of five arrays (chrom < 2^16, checked by the
    caller)."""
    w1 = start.to(torch.int64) * (1 << 32) + end.to(torch.int64)
    sbits = size.to(torch.float32).view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    w2 = (lens.to(torch.int64)[:, None] * (1 << 48)
          + chrom.to(torch.int64) * (1 << 32) + sbits)
    return w1, w2


def _unpack(w1g, w2g):
    st = (w1g >> 32).to(torch.int32)
    en = (w1g & 0xFFFFFFFF).to(torch.int32)
    sz = (w2g & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
    ch = ((w2g >> 32) & 0xFFFF).to(torch.int32)
    ln = (w2g[:, 0] >> 48).to(torch.int32)
    return ch, st, en, sz, ln


def _value(key, eo, w1, w2, cut, over, pct: float, ts: int, mn: int,
           M: int):
    """A chunk of entries -> (j float32, passv, gated, eq, run id, over):
    the greedy Jaccard of each (query, other) pair from the packed tables,
    its cutoff compared in float64, as fslr_tpu's ``_value_fn``."""
    eqs = key // ts
    rungid = key // mn
    R2 = w1.shape[0]
    a = eqs.clamp(0, R2 - 1)
    b = eo.to(torch.int64).clamp(0, R2 - 1)
    iota = torch.arange(M, device=key.device)[None, :]
    c1, s1, e1, z1, la = _unpack(w1[a], w2[a])
    c2, s2, e2, z2, lb = _unpack(w1[b], w2[b])
    j, n = jaccard._jaccard_impl(c1, s1, e1, z1, iota < la[:, None],
                                 c2, s2, e2, z2, iota < lb[:, None],
                                 la, lb, pct, M)
    gated = n > 0
    tgt = cut[(n.to(torch.int64) - 1).clamp(0, cut.numel() - 1)]
    passv = gated & (j.to(torch.float64) >= tgt)
    ov = torch.isin(a, over) | torch.isin(b, over)
    return j, passv, gated, eqs, rungid, ov


def _replay(passv, gated, rungid, eqs, T: int):
    """Emission mask of a chunk of whole queries: :func:`replay` in torch
    ops, with the query and run starts found from changes of ``eqs`` and
    ``rungid`` (fslr_tpu's ``_replay_fn``, whose cumulative-max fills were
    there to avoid TPU scatters and gathers)."""
    n = passv.numel()
    pi = passv.to(torch.int64)
    cum = torch.cumsum(pi, 0)
    qc = torch.ones(n, dtype=torch.bool, device=passv.device)
    qc[1:] = eqs[1:] != eqs[:-1]
    qid = torch.cumsum(qc, 0) - 1
    base_cp = (cum - pi)[qc][qid]
    cp = cum - base_cp
    capped = (cp - pi) >= T
    rc = torch.ones(n, dtype=torch.bool, device=passv.device)
    rc[1:] = rungid[1:] != rungid[:-1]
    run_index = torch.cumsum(rc, 0) - 1
    capev = passv & (cp == T)                # the T-th pass (<= 1 a query)
    caprun = torch.full((int(qc.sum()),), -1, dtype=torch.int64,
                        device=passv.device)
    caprun[qid[capev]] = run_index[capev]
    in_cap_run = capped & (run_index == caprun[qid])
    gi = gated.to(torch.int64)
    gex = torch.cumsum(gi, 0) - gi
    first_g = gated & (gex == gex[rc][run_index])
    return (passv & ~capped) | (capped & ~in_cap_run & first_g & passv)


def _compress(emit, eo, j64, base: int):
    """(global entry index, other read, j) of the emitted entries."""
    idx = torch.nonzero(emit).flatten()
    return idx + base, eo[idx].to(torch.int64), j64[idx]


def _rows(mask, eqs, eo):
    """(chunk index, query and other read on the host) of the masked
    entries: the pairs the exact host mirror values."""
    idx = torch.nonzero(mask).flatten()
    return idx, eqs[idx].cpu().numpy(), eo[idx].to(torch.int64).cpu().numpy()


def resolve_device(buckets, bounds: np.ndarray, max_itv: int, max_nc: int,
                   dev_arrays, M: int, pct: float, cutoffs,
                   edge_threshold: int, over: np.ndarray, host_value,
                   chunk: int = CHUNK):
    """Value and replay entries that stay on the device.

    Args:
      buckets: [(key, eo, base, n)] -- traversal keys (int64) and other
        reads per bucket on the device, ``base`` its global entry offset
        (ops/encounters.EntrySet.device_buckets); queries never span
        buckets.
      bounds: (R+1,) global per-read entry ranges.
      dev_arrays: the interval tables of jaccard.upload_interval_arrays.
      over: read ids whose interval lists exceed M (exact host Jaccard).
      host_value: (eq, eo) -> (j float64, n) exact host values.

    Returns (idx, eo, j) numpy arrays in global traversal order, j float64
    (the device's float32 exactly upcast; exact for pairs of ``over``).
    One copy to the host at the end.
    """
    chrom, start, end, size, lens = dev_arrays
    dev = chrom.device
    w1, w2 = _pack_tables(chrom, start, end, size, lens)
    cutn = np.asarray(cutoffs, np.float64)
    cut = torch.as_tensor(cutn, device=dev)
    over_d = torch.as_tensor(np.asarray(over, np.int64), device=dev)
    ts, mn = int(max_itv) * int(max_nc), int(max_nc)
    R = len(bounds) - 1
    outs = []
    for key_d, eo_d, base, nb in buckets:
        if nb == 0:
            continue
        q0 = int(np.searchsorted(bounds, base, side='left'))
        while q0 < R:
            b0 = int(bounds[q0])
            if b0 >= base + nb:
                break
            q1 = int(np.searchsorted(bounds, b0 + chunk, side='left'))
            q1 = min(max(q1, q0 + 1), R)
            b1 = min(int(bounds[q1]), base + nb)
            key_c = key_d[b0 - base:b1 - base]
            eo_c = eo_d[b0 - base:b1 - base]
            j, passv, gated, eqs, rungid, ov = _value(
                key_c, eo_c, w1, w2, cut, over_d, pct, ts, mn, M)
            j64 = j.to(torch.float64)
            if len(over) and bool(ov.any()):
                li, qa, qb = _rows(ov, eqs, eo_c)
                jh, nh = host_value(qa, qb)
                gh = nh != 0
                ph = gh & (jh >= cutn[np.clip(nh - 1, 0, len(cutn) - 1)])
                passv[li] = torch.as_tensor(ph, device=dev)
                gated[li] = torch.as_tensor(gh, device=dev)
                j64[li] = torch.as_tensor(jh, dtype=torch.float64,
                                          device=dev)
            emit = _replay(passv, gated, rungid, eqs, int(edge_threshold))
            outs.append(_compress(emit, eo_c, j64, b0))
            q0 = q1
    if not outs:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64)
    return tuple(torch.cat([o[i] for o in outs]).cpu().numpy()
                 for i in range(3))
