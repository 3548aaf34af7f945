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
stages/cluster.py replays the walk exactly over the full stream
(``_exact_capped_walk``).  The JAX package's device scale path
(``value_and_replay_host``, ``resolve_device``) is not ported: it waits
with ops/encounters.py (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

from fslr_tpu_torch.ops import jaccard


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
                  host_arrays=None):
    """(j64, n_i) for every (eq, eo) pair entry: batched device Jaccard,
    the exact host mirror for reads whose interval lists exceed the table
    width M.  j is float64 (device float32 exactly upcast).

    ``host_arrays`` = (chrom_a, start_a, end_a, size_a, lens_a): when
    given, pairs where BOTH reads have exactly ONE interior interval are
    valued on the host in closed form (j = 1 on a reciprocal-overlap
    match, else 0; jaccard_host's own float64 arithmetic)."""
    E = len(eq)
    j64 = np.zeros(E, np.float64)
    n_i = np.zeros(E, np.int64)
    if E == 0:
        return j64, n_i
    if len(over):
        ovm = np.isin(eq, over) | np.isin(eo, over)
    else:
        ovm = np.zeros(E, bool)
    single = np.zeros(E, bool)
    if host_arrays is not None:
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
