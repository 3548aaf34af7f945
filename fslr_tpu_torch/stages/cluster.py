"""Breakpoint clustering on numpy columns (no pandas).

Counterpart of ``fslr_tpu/stages/cluster.py``'s host path, with the same
cluster and representative beds.  A bed is a dict of equal-length numpy
columns in file order, typed as pandas would read ``mappings.bed``
(:func:`read_mappings`).

  * chromosomes get numeric ids in (chrN number, name) order;
  * ``filter_false`` drops reads whose name contains 'False';
  * each read's first and last rows (the primer-side "bread") are dropped;
    qlen2 = the interior's query span;
  * intervals are sorted by start (stably) and masked (chromosome list,
    'subtelomere' = within 500 kb of a > 1 Mbp chromosome's end);
  * the reference's traversal (query in first-seen order, each of its
    intervals, overlapping intervals in ascending-start order, pair dedup,
    qlen2 / n_alignments gate, greedy Jaccard with a cutoff per
    intersection count, a soft cap of ``edge_threshold`` edges per query)
    is replayed exactly: pair values are batched (ops/jaccard.py on the
    given device), the walk is a closed form (ops/capwalk.py) or, once a
    query caps, an exact sequential replay of the full encounter stream;
  * connected components (ops/components.py) in first-seen node order;
  * every row gets its read's cluster id and size (singletons after the
    components, size 1); representatives are the rows of the read with the
    highest mean alignment score per cluster (first such row on ties).

At ``device_enum_min_encounters`` encounters and above, the scale path
enumerates the encounters and reduces them to pairs on the device
(ops/encounters.py) and values and replays the capped walk there
(ops/capwalk.resolve_device), in its closed form even where a query caps.
"""

from __future__ import annotations

import codecs
import csv
import dataclasses
import os
import re
import sys
from collections import namedtuple

import numpy as np
import torch

from fslr_tpu_torch.config import ClusterConfig
from fslr_tpu_torch.instrument import count, span
from fslr_tpu_torch.io import native
from fslr_tpu_torch.ops import capwalk, components, encounters, jaccard
from fslr_tpu_torch.parallel import cluster_merge, dispatch

# max encounters materialized per enumeration slice (see query_graph)
ENCOUNTER_SLICE_CAP = 32 * 1024 * 1024

IntervalItem = namedtuple(
    'IntervalItem',
    ['chrom', 'start', 'end', 'aln_size', 'qname', 'n_alignments', 'qlen2',
     'middle', 'index'])


# ---------------------------------------------------------------------------
# Columns
# ---------------------------------------------------------------------------

def _take(bed: dict, idx) -> dict:
    return {k: v[idx] for k, v in bed.items()}


# pandas' default NA tokens (pandas._libs.parsers.STR_NA_VALUES): both of
# its engines read these cells, exactly as written, as missing
NA_TOKENS = frozenset((
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
    'nan', 'null'))
ENGINES = ('c', 'pyarrow')
_DEC = r'(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?|inf(?:inity)?'
# per engine: integer and float cells (ASCII digits only, spaces around a
# number allowed), and the boolean tokens
_INT = {'c': re.compile(r' *[+-]?[0-9]+ *'),
        'pyarrow': re.compile(r' *(?:-?[0-9]+|0[xX][0-9a-fA-F]+) *')}
_FLOAT = {'c': re.compile(r' *[+-]?(?:' + _DEC + r') *', re.I),
          'pyarrow': re.compile(r' *[+-]?(?:' + _DEC
                                + r'|nan(?:\([0-9a-z_]*\))?) *', re.I)}
_PA_TRUE = frozenset(('True', 'TRUE', 'true', '1'))
_PA_FALSE = frozenset(('False', 'FALSE', 'false', '0'))
_I64 = (-2 ** 63, 2 ** 63 - 1)


def _int_value(cell: str) -> int:
    cell = cell.strip(' ')
    return int(cell, 16) if cell[1:2] in ('x', 'X') else int(cell)


def _float_value(cell: str) -> float:
    cell = cell.strip(' ')
    return float('nan') if cell.lower().lstrip('+-').startswith('nan') \
        else float(cell)


def _bool_value(cell: str, engine: str):
    """True or False for a boolean token of ``engine``, else None (the C
    engine takes 'true' and 'false' in any case; pyarrow takes three
    spellings of each and 1 and 0)."""
    if engine == 'c':
        return {'true': True, 'false': False}.get(cell.lower())
    return True if cell in _PA_TRUE else False if cell in _PA_FALSE \
        else None


def _parse_column(cells: list[str], engine: str = 'pyarrow') -> np.ndarray:
    """One TSV column typed as ``pd.read_csv(sep='\\t', engine=engine)``
    types it, for the C engine (``'c'``) or ``'pyarrow'``:

    * a cell of ``NA_TOKENS`` is missing (NaN);
    * int64 when every other cell is an integer: ASCII digits with an
      optional sign (pyarrow: '-' only, or hexadecimal ``0x..``), spaces
      around it allowed; float64 (NaN where missing) when some cell is
      missing;
    * else float64 when every other cell is a float (digits, a point, an
      exponent, ``inf`` or ``infinity``; pyarrow also ``nan`` in any case);
    * else bool when every other cell is a boolean token
      (:func:`_bool_value`), objects True / False / NaN (pyarrow: None)
      when some cell is missing;
    * else strings, NaN where missing.

    So '11_1', '1_000.5' and non-ASCII digits stay strings, as in pandas
    (Python's ``int()`` and ``float()`` accept them).  The engines differ
    on '+5' (C: int, pyarrow: float) and '0x10' (pyarrow: int 16, C: a
    string).  Not followed: an integer beyond int64 is a float in pyarrow,
    uint64 in the C engine when none is negative or missing, else a
    string here (pandas may give Python ints); pyarrow's dates and times
    stay strings.  A column without rows is int64."""
    full = [c for c in cells if c not in NA_TOKENS]
    missing = len(full) < len(cells)

    def column(values, dtype):
        if not missing:
            return np.array(values, dtype)
        it = iter(values)
        fill = None if dtype is object and engine == 'pyarrow' else np.nan
        out = np.empty(len(cells), dtype if dtype is object else np.float64)
        out[:] = [fill if c in NA_TOKENS else next(it) for c in cells]
        return out

    all_int = all(_INT[engine].fullmatch(c) for c in full)
    if all_int:
        ints = [_int_value(c) for c in full]
        if all(_I64[0] <= v <= _I64[1] for v in ints):
            return column(ints, np.int64)
        if engine == 'c' and not missing and min(ints) >= 0 \
                and max(ints) < 2 ** 64:
            return np.array(ints, np.uint64)
    # pyarrow reads an integer beyond int64 as a float
    if not (all_int and engine == 'c') and \
            all(_FLOAT[engine].fullmatch(c) for c in full):
        return column([_float_value(c) for c in full], np.float64)
    if full and all(_bool_value(c, engine) is not None for c in full):
        return column([_bool_value(c, engine) for c in full],
                      bool if not missing else object)
    out = np.empty(len(cells), object)
    out[:] = [np.nan if c in NA_TOKENS else c for c in cells]
    return out


def _csv_columns(path: str) -> tuple[list, list]:
    """The header and the columns of ``path`` by the csv module: the route
    of a file that is no rectangle of cells, oddities kept (a blank line
    or a short row truncates every column, as ``zip`` does)."""
    with open(path, newline='') as fh:
        rows = list(csv.reader(fh, delimiter='\t'))
    header, body = rows[0], rows[1:]
    return header, list(zip(*body)) if body else [()] * len(header)


def _native_column(table, j: int, engine: str, encoding: str) -> np.ndarray:
    """Column ``j`` of a :class:`native.TsvTable` as :func:`_parse_column`
    types it; only its distinct strings become Python objects."""
    values, uniques = table.column(j)
    kind = table.kinds[j]
    if kind == native.TSV_BOOL_NA:
        fill = None if engine == 'pyarrow' else np.nan
        return np.array([False, True, fill], object)[values]
    if uniques is None:
        return values
    decoded = uniques.decode(encoding).split('\0')
    strings = np.empty(len(decoded), object)
    strings[:] = decoded
    if kind == native.TSV_CELLS:
        return _parse_column(strings[values].tolist(), engine)
    if not NA_TOKENS.isdisjoint(decoded):
        strings[[s in NA_TOKENS for s in decoded]] = np.nan
    return strings[values]


def read_mappings(path: str, engine: str = 'pyarrow') -> dict:
    """``{name}.mappings.bed`` as typed numpy columns, as
    ``pd.read_csv(path, sep='\\t', engine=engine)`` types them
    (:func:`_parse_column`): clustering reads it as fslr_tpu does, with
    ``'pyarrow'``; the merges of a multi-process run and of the consensus
    stage with the C engine (``'c'``).

    The file's bytes are tokenized and typed by the host runtime
    (``io/native.TsvTable``) as the csv module and :func:`_parse_column`
    would: step ``parse`` reads and classifies, ``typing`` builds the
    columns.  A column holding a form the runtime does not convert goes
    to :func:`_parse_column` from its cells, and a file that is no
    rectangle of cells, or not in UTF-8 or ASCII (the encoding
    ``open`` gives it), to the csv module whole.  The active timer's
    ``read_mappings`` note counts ``native_columns``, ``python_columns``
    and ``python_file`` (files read whole by the csv module)."""
    if engine not in ENGINES:
        raise ValueError(f'engine {engine!r}: one of {ENGINES}')
    with span('parse'):
        with open(path, newline='') as fh:
            encoding = fh.encoding
            data = bytearray(os.fstat(fh.fileno()).st_size)
            del data[fh.buffer.readinto(data):]
            data += fh.buffer.read()
        table = None
        if codecs.lookup(encoding).name in ('utf-8', 'ascii'):
            table = native.TsvTable(data, engine, csv.field_size_limit())
            if not table.rectangular:
                table.close()
                table = None
        if table is None:
            header, cols = _csv_columns(path)
    if table is None:
        count('read_mappings', native_columns=0, python_columns=0,
              python_file=1)
        with span('typing'):
            return {h: _parse_column(list(c), engine)
                    for h, c in zip(header, cols)}
    with table, span('typing'):
        header = table.header().decode(encoding).split('\0')
        cols = [_native_column(table, j, engine, encoding)
                for j in range(table.ncols)]
    cells = table.kinds.count(native.TSV_CELLS)
    count('read_mappings', native_columns=len(cols) - cells,
          python_columns=cells, python_file=0)
    return {h: c for h, c in zip(header, cols)}


def _first_index(keys: np.ndarray):
    """(unique keys in first-seen order, group id per row in that order)."""
    uniq, first, inv = np.unique(keys, return_index=True,
                                 return_inverse=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first, kind='stable')] = np.arange(len(uniq))
    return uniq[np.argsort(first, kind='stable')], rank[inv.reshape(-1)]


# ---------------------------------------------------------------------------
# Preparation (fslr_tpu.stages.cluster: rename_chromosomes .. prepare_data)
# ---------------------------------------------------------------------------

def rename_chromosomes(bed, chromosome_lengths, chromosome_mask):
    def sort_key(x):
        num = (int(x[3:]) if x[:3] == 'chr' and x[3:].isdigit()
               else float('inf'))
        return (num, x)
    names = sorted(set(bed['chrom'].tolist()), key=sort_key)
    cmap = {name: i + 1 for i, name in enumerate(names)}
    chr_lengths = {cmap.get(k): v for k, v in chromosome_lengths.items()}
    bed = dict(bed)
    bed['chrom'] = np.array([cmap[c] for c in bed['chrom'].tolist()],
                            np.int64)
    chromosome_mask = [cmap.get(x) if x != 'subtelomere' else x
                       for x in chromosome_mask]
    return bed, chr_lengths, chromosome_mask, cmap


def chrom_to_str(bed, cmap):
    num_to_str = {v: k for k, v in cmap.items()}
    out = np.empty(len(bed['chrom']), object)
    out[:] = [num_to_str[c] for c in bed['chrom'].tolist()]
    return {**bed, 'chrom': out}


def delete_false(bed):
    return _take(bed, np.array(['False' not in q for q in
                                bed['qname'].tolist()], bool))


def keep_fillings(bed):
    """Drop each read's first and last row; qlen2 = max(qend) -
    min(qstart) over the rows left."""
    qn = bed['qname']
    n = len(qn)
    _, gid = _first_index(qn)
    rows = np.arange(n)
    first = np.full(gid.max() + 1 if n else 0, n, np.int64)
    last = np.full(len(first), -1, np.int64)
    np.minimum.at(first, gid, rows)
    np.maximum.at(last, gid, rows)
    bread = (rows == first[gid]) | (rows == last[gid])
    out = _take(bed, ~bread)
    out['_row'] = rows[~bread]
    _, g2 = _first_index(out['qname'])
    k = g2.max() + 1 if len(g2) else 0
    qe = out['qend']
    qs = out['qstart']
    mx = np.full(k, np.iinfo(np.int64).min if qe.dtype.kind == 'i'
                 else -np.inf, qe.dtype)
    mn = np.full(k, np.iinfo(np.int64).max if qs.dtype.kind == 'i'
                 else np.inf, qs.dtype)
    np.maximum.at(mx, g2, qe)
    np.minimum.at(mn, g2, qs)
    out['qlen2'] = mx[g2] - mn[g2]
    return out


def calc_coverage(bed, chromosome_lengths):
    coverage = {}
    chrom = bed['chrom']
    for c in np.unique(chrom).tolist():
        if c not in chromosome_lengths:
            continue
        sel = chrom == c
        cov = np.zeros(chromosome_lengths[c] + 1)
        np.add.at(cov, bed['rstart'][sel], 1)
        np.add.at(cov, bed['rend'][sel], -1)
        coverage[c] = np.cumsum(cov)
    return coverage


def filter_high_coverage(data, bed, chromosome_lengths, threshold):
    cov = calc_coverage(bed, chromosome_lengths)
    return [a for a in data if cov[a.chrom][a.middle] <= threshold]


def mask_sequences(data, mask, chromosome_lengths, threshold=500_000):
    if not mask:
        return data
    chromosome_lengths = {k: v for k, v in chromosome_lengths.items()
                          if v > 1_000_000}
    out = []
    for a in data:
        if a.chrom in mask:
            continue
        if 'subtelomere' in mask:
            if a.chrom in chromosome_lengths and \
                    (a.start < threshold
                     or chromosome_lengths[a.chrom] - a.end < threshold):
                continue
        out.append(a)
    return out


def prepare_data(bed, cluster_mask, chromosome_lengths, threshold=500_000):
    start = np.minimum(bed['rstart'], bed['rend'])
    end = np.maximum(bed['rstart'], bed['rend'])
    middle = bed['aln_size'] // 2 + start
    order = np.argsort(start, kind='stable')
    cols = [start, end, bed['aln_size'], bed['qname'], bed['n_alignments'],
            bed['qlen2'], middle, bed['_row']]
    data = [IntervalItem(*vals) for vals in
            zip(bed['chrom'][order].tolist(),
                *(c[order].tolist() for c in cols))]
    if cluster_mask:
        data = mask_sequences(data, cluster_mask, chromosome_lengths,
                              threshold)
    return data


class _ChromIndex:
    """Sorted starts + prefix-max ends per chromosome; overlap queries in
    ascending-start order."""

    def __init__(self, data):
        self.by_chrom = {}
        for itv in data:
            self.by_chrom.setdefault(itv.chrom, []).append(itv)
        self.arrays = {}
        for chrom, items in self.by_chrom.items():
            starts = np.array([i.start for i in items])
            ends = np.array([i.end for i in items])
            pmax = np.maximum.accumulate(ends)
            self.arrays[chrom] = (starts, ends, pmax, items)

    def search(self, chrom, start, end):
        if chrom not in self.arrays:
            return []
        starts, ends, pmax, items = self.arrays[chrom]
        hi = np.searchsorted(starts, end, side='right')
        lo = np.searchsorted(pmax[:hi], start, side='left')
        if lo >= hi:
            return []
        sel = np.nonzero(ends[lo:hi] >= start)[0] + lo
        return [items[i] for i in sel]


# ---------------------------------------------------------------------------
# The graph (fslr_tpu.stages.cluster.query_graph, host path)
# ---------------------------------------------------------------------------

def query_graph(data, overlap_cutoff, jaccard_cutoffs, edge_threshold,
                qlen_diff, n_aln_diff, cfg: ClusterConfig,
                device: torch.device, stats: dict | None = None):
    """Returns (match set of (query1, query2, jaccard), edges in add order,
    node first-seen order) of the reference traversal.  From
    ``cfg.device_enum_min_encounters`` encounters on it takes the scale
    path (:func:`_query_graph_device`), which fills ``stats`` with its
    path and sizes.  Either path times its steps as spans
    (``instrument.span``): ``tables`` (the per-read tables, the interval
    index, the jobs and the tables' upload), ``enum_merge`` (1),
    ``gate_order`` (2), ``value_replay`` (3) and ``emit`` (4).

      1. the encounter stream is enumerated in traversal order (query
         first-seen order, interval list order, ascending-start neighbour
         order) and reduced to each pair's first encounter;
      2. the seen-pair dedup and the qlen2/n_alignments gate are static;
      3. every gated pair's greedy Jaccard is valued in batches on
         ``device``, and the capped walk's emissions follow in closed
         form (ops/capwalk.py) -- or, when some query reaches the cap, by
         the exact replay over the full multi-occurrence stream;
      4. emissions arrive in traversal order, so match/edges/node order
         are the reference's.
    """
    with span('tables'):
        query_intervals = {}
        for itv in data:
            query_intervals.setdefault(itv.qname, []).append(itv)
        index = _ChromIndex(data)

        def as_tuples(lst):
            return [(i.chrom, i.start, i.end, i.aln_size) for i in lst]

        qnames_order = list(query_intervals.keys())
        qid = {q: i for i, q in enumerate(qnames_order)}
        R = len(qnames_order)
        M = cfg.max_intervals_per_read
        chrom_a = np.zeros((R, M), np.int32)
        start_a = np.zeros((R, M), np.int32)
        end_a = np.zeros((R, M), np.int32)
        size_a = np.zeros((R, M), np.float32)
        lens_a = np.zeros(R, np.int32)
        itv_rank = {}
        for q, lst in query_intervals.items():
            r = qid[q]
            lens_a[r] = len(lst)
            for i, itv in enumerate(lst):
                itv_rank[id(itv)] = i
                if i < M:
                    chrom_a[r, i] = itv.chrom
                    start_a[r, i] = itv.start
                    end_a[r, i] = itv.end
                    size_a[r, i] = itv.aln_size
        qlen2_arr = np.zeros(R, np.float64)
        naln_arr = np.zeros(R, np.float64)
        for q, lst in query_intervals.items():
            qlen2_arr[qid[q]] = lst[0].qlen2
            naln_arr[qid[q]] = lst[0].n_alignments

        # table width: the smallest power of two >= 2 covering the longest
        # list (at most M); longer lists take the exact host path
        if R:
            mx = int(lens_a.max())
            M_eff = 2
            while M_eff < min(mx, M):
                M_eff *= 2
            if M_eff < M:
                M = M_eff
                chrom_a, start_a, end_a, size_a = (
                    chrom_a[:, :M], start_a[:, :M], end_a[:, :M],
                    size_a[:, :M])

        max_itv = max((len(v) for v in query_intervals.values()), default=1)
        max_nc = max((len(v[3]) for v in index.arrays.values()), default=1) + 1
        trav_scale = max_itv * max_nc

        jobs = []       # (rid_arr, irk_arr, starts, ends, lo, counts, ccum)
        total_enc = 0
        for chrom, (starts, ends, pmax, items) in index.arrays.items():
            nc = len(items)
            if nc == 0:
                continue
            rid_arr = np.fromiter((qid[i.qname] for i in items), np.int64, nc)
            irk_arr = np.fromiter((itv_rank[id(i)] for i in items),
                                  np.int64, nc)
            hi = np.searchsorted(starts, ends, side='right')
            lo = np.minimum(np.searchsorted(pmax, starts, side='left'), hi)
            counts = hi - lo
            total = int(counts.sum())
            if total == 0:
                continue
            total_enc += total
            ccum = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            jobs.append((rid_arr, irk_arr, np.asarray(starts),
                         np.asarray(ends), lo, counts, ccum))

        dev_arrays = jaccard.upload_interval_arrays(
            chrom_a, start_a, end_a, size_a, np.minimum(lens_a, M), device)
        host_arrays = (chrom_a, start_a, end_a, size_a, lens_a)
        over = np.nonzero(lens_a > M)[0]

    def host_value(eqs, eos):
        """Exact host greedy Jaccard for reads whose interval lists
        exceed the table width M."""
        jh = np.empty(len(eqs), np.float64)
        nh = np.empty(len(eqs), np.int64)
        for r in range(len(eqs)):
            jh[r], nh[r] = jaccard.jaccard_host(
                as_tuples(query_intervals[qnames_order[int(eqs[r])]]),
                as_tuples(query_intervals[qnames_order[int(eos[r])]]),
                overlap_cutoff)
        return jh, nh

    if total_enc >= cfg.device_enum_min_encounters \
            and trav_scale < (1 << 30) \
            and (chrom_a.max(initial=0) < (1 << 16)):
        # the scale path; trav_scale >= 2^30 would overflow its 31-bit
        # traversal state and chromosome ids >= 2^16 its packed interval
        # tables, so such datasets stay on the host path
        return _query_graph_device(
            jobs, R, max_itv, max_nc, qlen2_arr, naln_arr, overlap_cutoff,
            jaccard_cutoffs, edge_threshold, qlen_diff, n_aln_diff, cfg,
            qnames_order, over, dev_arrays, M, host_value, host_arrays,
            device, {} if stats is None else stats)

    with span('enum_merge'):
        # bounded-memory enumeration: interval ranges in slices of at most
        # ENCOUNTER_SLICE_CAP encounters, each reduced to per-pair minima
        tv_span = trav_scale * R + 1        # tv < trav_scale * R

        def _reduce(pk, tv):
            if R * R < (1 << 62) // tv_span:
                # one fused key: the first of each pk group is its minimum
                fused = np.sort(pk * tv_span + tv)
                pk_s = fused // tv_span
                grp = np.concatenate([[0], np.nonzero(np.diff(pk_s))[0] + 1])
                return pk_s[grp], fused[grp] % tv_span
            ord1 = np.argsort(pk)
            pk_s = pk[ord1]
            tv_s = tv[ord1]
            grp = np.concatenate([[0], np.nonzero(np.diff(pk_s))[0] + 1])
            return pk_s[grp], np.minimum.reduceat(tv_s, grp)

        red_pk, red_tv = [], []
        for rid_arr, irk_arr, starts, ends, lo, counts, ccum in jobs:
            nc = len(starts)
            total = int(counts.sum())
            cuts = [0]
            while cuts[-1] < nc:
                nxt = int(np.searchsorted(ccum, ccum[cuts[-1]]
                                          + ENCOUNTER_SLICE_CAP, side='left'))
                cuts.append(min(max(nxt, cuts[-1] + 1), nc))
            idt = np.int32 if total < 2**31 and nc < 2**31 else np.int64
            for s0, s1 in zip(cuts[:-1], cuts[1:]):
                cnt_s = counts[s0:s1]
                tot_s = int(cnt_s.sum())
                if tot_s == 0:
                    continue
                qx = np.repeat(np.arange(s0, s1, dtype=idt), cnt_s)
                offs = ccum[s0:s1] - ccum[s0]
                nx = (np.arange(tot_s, dtype=idt)
                      - np.repeat((offs - lo[s0:s1]).astype(idt), cnt_s))
                keep = ends[nx] >= starts[qx]
                qx, nx = qx[keep], nx[keep]
                a, b = rid_arr[qx], rid_arr[nx]
                ok = a != b
                a, b, qx, nx = a[ok], b[ok], qx[ok], nx[ok]
                if not len(a):
                    continue
                pk = np.minimum(a, b) * R + np.maximum(a, b)
                # traversal key: query first-seen order, interval rank, then
                # ascending-start neighbour sequence (nx)
                tv = (a * max_itv + irk_arr[qx]) * max_nc + nx
                pk, tv = _reduce(pk, tv)
                red_pk.append(pk)
                red_tv.append(tv)
        if red_pk:
            pair_pk, pair_tv = _reduce(np.concatenate(red_pk),
                                       np.concatenate(red_tv))

    with span('gate_order'):
        if red_pk:
            eorder = np.argsort(pair_tv)
            tv_e = pair_tv[eorder]
            pk_e = pair_pk[eorder]
            eq = tv_e // trav_scale
            ei = (tv_e // max_nc) % max_itv
            p_lo = pk_e // R
            p_hi = pk_e % R
            eo = np.where(eq == p_lo, p_hi, p_lo)
            q_ok = (np.minimum(qlen2_arr[eq], qlen2_arr[eo])
                    / np.maximum(np.maximum(qlen2_arr[eq], qlen2_arr[eo]),
                                 1e-12)) >= 1 - qlen_diff
            n_ok = (np.minimum(naln_arr[eq], naln_arr[eo])
                    / np.maximum(naln_arr[eq], naln_arr[eo])) \
                >= 1 - n_aln_diff
            gate = q_ok | n_ok          # "not different"
            eq, ei, eo = eq[gate], ei[gate], eo[gate]
        else:
            eq = ei = eo = np.zeros(0, np.int64)

    with span('value_replay'):
        bounds = np.searchsorted(eq, np.arange(R + 1))
        j64, n_i = capwalk.value_entries(eq, eo, dev_arrays, M,
                                         overlap_cutoff, over, host_value,
                                         host_arrays)
        passv, gated_e = capwalk.pass_flags(j64, n_i, list(jaccard_cutoffs))
        if cfg.exact_cap_replay and len(eq) \
                and (capwalk.pass_counts(passv, bounds)
                     >= edge_threshold).any():
            # a query reaches the soft edge cap: a capped break leaves
            # pairs unseen for re-testing, so replay the walk exactly over
            # the full stream, each event valued in the direction it is
            # reached
            j64r, n_ir = capwalk.value_entries(eo, eq, dev_arrays, M,
                                               overlap_cutoff, over,
                                               host_value, host_arrays)
            passr, _ = capwalk.pass_flags(j64r, n_ir, list(jaccard_cutoffs))
            pk_v = np.minimum(eq, eo) * R + np.maximum(eq, eo)
            vord = np.argsort(pk_v)
            eq_e, eo_e, j_e = _exact_capped_walk(
                jobs, R, max_itv, max_nc, edge_threshold,
                pk_v[vord], eq[vord],
                (j64[vord], n_i[vord], passv[vord]),
                (j64r[vord], n_ir[vord], passr[vord]))
        else:
            rc = np.ones(len(eq), bool)
            rc[1:] = (eq[1:] != eq[:-1]) | (ei[1:] != ei[:-1])
            emit = capwalk.replay(passv, gated_e, rc, eq, bounds,
                                  edge_threshold)
            idx_e = np.flatnonzero(emit)
            eq_e = np.searchsorted(bounds, idx_e, side='right') - 1
            eo_e, j_e = eo[idx_e], j64[idx_e]
    with span('emit'):
        return _emit_from_pairs(eq_e, eo_e, j_e, qnames_order)


class _ConsumedSet:
    """Grow-only int64 membership set with vectorized queries (sorted
    base + small pending buffers, merged when the buffer fills)."""

    def __init__(self):
        self._sorted = np.empty(0, np.int64)
        self._pending: list[np.ndarray] = []
        self._npend = 0

    def contains(self, x: np.ndarray) -> np.ndarray:
        if len(self._sorted):
            ix = np.searchsorted(self._sorted, x)
            ix = np.minimum(ix, len(self._sorted) - 1)
            out = self._sorted[ix] == x
        else:
            out = np.zeros(len(x), bool)
        for p in self._pending:
            out |= np.isin(x, p)
        return out

    def add(self, arr: np.ndarray):
        if not len(arr):
            return
        self._pending.append(np.asarray(arr, np.int64))
        self._npend += len(arr)
        if self._npend > 65536 or len(self._pending) > 12:
            self._sorted = np.unique(np.concatenate(
                [self._sorted, *self._pending]))
            self._pending = []
            self._npend = 0


def _first_occurrence_mask(pk: np.ndarray) -> np.ndarray:
    """True at each value's first occurrence (positional order)."""
    n = len(pk)
    if n < 2:
        return np.ones(n, bool)
    o = np.argsort(pk, kind='stable')
    ps = pk[o]
    f = np.empty(n, bool)
    f[0] = True
    f[1:] = ps[1:] != ps[:-1]
    out = np.empty(n, bool)
    out[o] = f
    return out


def _exact_capped_walk(jobs, R, max_itv, max_nc, edge_threshold,
                       pk_valued, eq_valued, fwd_vals, rev_vals):
    """Exact sequential replay of the reference traversal over the FULL
    multi-occurrence encounter stream, for when some query reaches the
    soft edge cap.  Only the seen-pair set and the per-query edge counter
    are dynamic; every pair's (jaccard, n_i, pass) comes precomputed
    (pk_valued sorted).  The stream is materialized in contiguous query
    chunks of ~ENCOUNTER_SLICE_CAP encounters; consumed pairs carry over
    in a _ConsumedSet.  Returns (eq, eo, j) per emission in traversal
    order."""
    ev_per_read = np.zeros(R + 1, np.int64)
    for rid_arr, irk_arr, starts, ends, lo, counts, ccum in jobs:
        np.add.at(ev_per_read, rid_arr, counts)
    cum = np.cumsum(ev_per_read[:R])
    total_ev = int(cum[-1]) if R else 0
    if total_ev == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64)
    n_chunks = max(1, -(-total_ev // ENCOUNTER_SLICE_CAP))
    targets = (np.arange(1, n_chunks) * (total_ev / n_chunks))
    splits = np.unique(np.searchsorted(cum, targets) + 1)
    r_bounds = np.unique(np.concatenate([[0], splits, [R]]))

    cons = _ConsumedSet()
    T = int(edge_threshold)
    out_eq, out_eo, out_j = [], [], []
    for r0, r1 in zip(r_bounds[:-1], r_bounds[1:]):
        res = _exact_walk_chunk(jobs, R, max_itv, max_nc, T, pk_valued,
                                eq_valued, fwd_vals, rev_vals, cons,
                                int(r0), int(r1))
        if res is not None:
            out_eq.append(res[0])
            out_eo.append(res[1])
            out_j.append(res[2])
    if not out_eq:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64)
    return (np.concatenate(out_eq), np.concatenate(out_eo),
            np.concatenate(out_j))


def _exact_walk_chunk(jobs, R, max_itv, max_nc, T, pk_valued,
                      eq_valued, fwd_vals, rev_vals, cons, r0, r1):
    """Materialize and walk the stream of queries [r0, r1)."""
    pks, tvs = [], []
    for rid_arr, irk_arr, starts, ends, lo, counts, ccum in jobs:
        qsel = np.flatnonzero((rid_arr >= r0) & (rid_arr < r1)
                              & (counts > 0))
        if not len(qsel):
            continue
        cnt_sel = counts[qsel]
        tot = int(cnt_sel.sum())
        qx = np.repeat(qsel, cnt_sel)
        base = np.concatenate([[0], np.cumsum(cnt_sel)])[:-1]
        nx = (np.arange(tot, dtype=np.int64)
              - np.repeat(base - lo[qsel], cnt_sel))
        keep = ends[nx] >= starts[qx]
        qx, nx = qx[keep], nx[keep]
        a, b = rid_arr[qx], rid_arr[nx]
        ok = a != b
        a, b, qx, nx = a[ok], b[ok], qx[ok], nx[ok]
        if not len(a):
            continue
        pks.append(np.minimum(a, b) * R + np.maximum(a, b))
        tvs.append((a * max_itv + irk_arr[qx]) * max_nc + nx)
    if not pks:
        return None
    pk = np.concatenate(pks)
    tv = np.concatenate(tvs)
    order = np.argsort(tv)              # tv unique: (read, rank, npos)
    pk, tv = pk[order], tv[order]
    E = len(pk)
    eq = tv // (max_itv * max_nc)
    run = tv // max_nc
    p_lo, p_hi = pk // R, pk % R
    oth = np.where(eq == p_lo, p_hi, p_lo)

    # static per-event flags: each event uses ITS direction's values
    vix = np.searchsorted(pk_valued, pk)
    vix_c = np.minimum(vix, max(len(pk_valued) - 1, 0))
    hasv = ((vix < len(pk_valued)) & (pk_valued[vix_c] == pk)
            if len(pk_valued) else np.zeros(E, bool))
    j_f, n_f, p_f = fwd_vals
    j_r, n_r, p_r = rev_vals
    is_fwd = eq == eq_valued[vix_c]
    gated = hasv & np.where(is_fwd, n_f[vix_c] > 0, n_r[vix_c] > 0)
    passf = hasv & np.where(is_fwd, p_f[vix_c], p_r[vix_c])
    jval = np.where(hasv, np.where(is_fwd, j_f[vix_c], j_r[vix_c]), 0.0)

    seg_bounds = np.searchsorted(eq, np.arange(r0, r1 + 1))
    emit_pos: list[int] = []
    for r in range(r1 - r0):
        s0, s1 = int(seg_bounds[r]), int(seg_bounds[r + 1])
        if s0 == s1:
            continue
        pk_s = pk[s0:s1]
        fresh = ~cons.contains(pk_s)
        firsts = _first_occurrence_mask(pk_s)
        freshf = fresh & firsts
        p_all = passf[s0:s1] & freshf
        if int(p_all.sum()) < T:
            # no cap: every encounter is reached; first occurrences of
            # unconsumed pairs are consumed, passing ones emit
            cons.add(pk_s[freshf])
            emit_pos.extend((s0 + np.flatnonzero(p_all)).tolist())
            continue
        # capped query: replay its runs sequentially
        run_s = run[s0:s1]
        rstarts = np.flatnonzero(
            np.concatenate([[True], run_s[1:] != run_s[:-1]]))
        rstops = np.concatenate([rstarts[1:], [s1 - s0]])
        e = 0
        local: set[int] = set()
        seg_consumed: list[np.ndarray] = []
        for a0, a1 in zip(rstarts, rstops):
            a0, a1 = int(a0), int(a1)
            pk_r = pk_s[a0:a1]
            fr = fresh[a0:a1] & _first_occurrence_mask(pk_r)
            if local:
                fr = fr & ~np.isin(
                    pk_r, np.fromiter(local, np.int64, len(local)))
            if e < T:
                pr = passf[s0 + a0:s0 + a1] & fr
                tot_p = int(pr.sum())
                if e + tot_p < T:
                    consumed = pk_r[fr]
                    emit_pos.extend(
                        (s0 + a0 + np.flatnonzero(pr)).tolist())
                    e += tot_p
                else:
                    cum = np.cumsum(pr)
                    cappos = int(np.argmax(cum >= T - e))
                    consumed = pk_r[:cappos + 1][fr[:cappos + 1]]
                    emit_pos.extend(
                        (s0 + a0
                         + np.flatnonzero(pr[:cappos + 1])).tolist())
                    e = T
            else:
                g = fr & gated[s0 + a0:s0 + a1]
                if g.any():
                    fv = int(np.argmax(g))
                    consumed = pk_r[:fv + 1][fr[:fv + 1]]
                    if passf[s0 + a0 + fv]:
                        emit_pos.append(s0 + a0 + fv)
                        e += 1
                else:
                    consumed = pk_r[fr]
            if len(consumed):
                local.update(consumed.tolist())
                seg_consumed.append(consumed)
        if seg_consumed:
            cons.add(np.concatenate(seg_consumed))
    pos = np.asarray(emit_pos, np.int64)
    return eq[pos], oth[pos], jval[pos]


def _emit_from_pairs(eq_e, eo_e, j_e, qnames_order):
    """match/edges/node order from the walk's emissions (query, other
    read, Jaccard) in traversal order."""
    match = set()
    edges = []
    node_pos = {}
    for qa, qb, j in zip(eq_e, eo_e, j_e):
        name_a = qnames_order[int(qa)]
        name_b = qnames_order[int(qb)]
        match.add((name_a, name_b, float(j)))
        if name_a not in node_pos:
            node_pos[name_a] = len(node_pos)
        if name_b not in node_pos:
            node_pos[name_b] = len(node_pos)
        edges.append((name_a, name_b))
    return match, edges, node_pos


def _query_graph_device(jobs, R, max_itv, max_nc, qlen2_arr, naln_arr,
                        overlap_cutoff, jaccard_cutoffs, edge_threshold,
                        qlen_diff, n_aln_diff, cfg: ClusterConfig,
                        qnames_order, over, dev_arrays, M, host_value,
                        host_arrays, device: torch.device, stats: dict):
    """The scale path of query_graph: the encounter stream is enumerated
    and reduced to pairs on ``device`` (ops/encounters.py); the entries
    stay there (in one set up to ``cfg.enum_spill_min_encounters``
    encounters, in buckets above it) or, above
    ``encounters.SPILL_DIRECT_MIN``, in host memory, and the capped walk
    is valued and replayed in closed form (ops/capwalk.py).  ``stats``
    gets the build's path and sizes; the steps are spans
    (``instrument.span``): ``enum_merge`` and ``gate_order`` in the
    build, then ``value_replay`` and ``emit``."""
    ents = encounters.build_entries(
        [encounters.ChromJob(starts=s, ends=e, lo=lo, ccum=ccum, rid=rid,
                             irk=irk)
         for (rid, irk, s, e, lo, counts, ccum) in jobs],
        R, max_itv, max_nc, qlen2_arr, naln_arr, 1.0 - qlen_diff,
        1.0 - n_aln_diff, cfg.enum_slice_cap, cfg.enum_merge_cap,
        cfg.enum_spill_min_encounters, device, stats)
    with span('value_replay'):
        bounds = ents.bounds
        cutoffs = list(jaccard_cutoffs)
        if isinstance(ents, encounters.HostEntrySet):
            # the spill path: entries in host memory, valued and replayed
            # in query-aligned chunks
            idx_e, eo_e, j_e = capwalk.value_and_replay_host(
                ents.ei, ents.eo, bounds, dev_arrays, M, overlap_cutoff,
                cutoffs, edge_threshold, over, host_value, host_arrays)
        else:
            idx_e, eo_e, j_e = capwalk.resolve_device(
                ents.device_buckets(), bounds, max_itv, max_nc, dev_arrays,
                M, overlap_cutoff, cutoffs, edge_threshold, over,
                host_value)
        del ents
        eq_e = np.searchsorted(bounds, idx_e, side='right') - 1
    # the scale path keeps the first-encounter closed form where a query
    # caps (the exact multi-occurrence walk is the host path's); a query
    # that emits edge_threshold edges has almost certainly capped
    if len(idx_e):
        n_cap = int((np.bincount(eq_e, minlength=R)
                     >= edge_threshold).sum())
        if n_cap:
            print(f'note: {n_cap} queries reached the soft edge cap '
                  f'({edge_threshold}) on the at-scale clustering path; '
                  f'capped walks use first-encounter edge semantics '
                  f'(measured against the exact walk by '
                  f'tools/cap_sweep.py: partitions equal on 99.6% of '
                  f'adversarial capped frames, divergence only splits '
                  f'over-cap-bridged clusters; see ops/capwalk.py)',
                  file=sys.stderr)
    with span('emit'):
        out = _emit_from_pairs(eq_e, eo_e, j_e, qnames_order)
    stats['edges'] = len(out[1])
    return out


def get_subgraphs(edges, node_pos, device: torch.device):
    """Connected components as a list of qname sets, ordered by first-seen
    node (networkx iteration order).

    Under an active mesh of several entries (parallel/dispatch) the edges
    are cut into one shard a mesh entry and merged by
    parallel/cluster_merge.merged_components, as fslr_tpu does; both
    label a component by its smallest node id, so the sets and their
    order are the same."""
    if not edges:
        return []
    n = len(node_pos)
    names = [None] * n
    for name, pos in node_pos.items():
        names[pos] = name
    earr = np.array([[node_pos[a], node_pos[b]] for a, b in edges],
                    dtype=np.int64)
    if dispatch.sharded():
        mesh = dispatch.active_mesh()
        per = -(-len(earr) // mesh.size)
        labels = cluster_merge.merged_components(
            mesh, [earr[i * per:(i + 1) * per] for i in range(mesh.size)],
            n, per)
    else:
        labels = components.connected_components(earr, n, device)
    comp_order = []
    comp_members = {}
    for pos in range(n):
        lbl = int(labels[pos])
        if lbl not in comp_members:
            comp_members[lbl] = set()
            comp_order.append(lbl)
        comp_members[lbl].add(names[pos])
    return [comp_members[lbl] for lbl in comp_order]


def choose_alignment(bed):
    """Representative reads: per cluster, every row of the read whose rows
    have the highest mean alignment_score (the first such row on ties, as
    pandas idxmax), with that mean as ``avg_alignment_score``."""
    _, qg = _first_index(bed['qname'])
    score = bed['alignment_score'].astype(np.float64)
    sums = np.bincount(qg, weights=score)
    cnt = np.bincount(qg)
    avg = (sums / cnt)[qg]
    _, cg = _first_index(bed['cluster'])
    rows = np.arange(len(avg))
    order = np.lexsort((rows, -avg, cg))
    first = np.ones(len(order), bool)
    first[1:] = cg[order][1:] != cg[order][:-1]
    winners = set(bed['qname'][order[first]].tolist())
    out = dict(bed)
    out['avg_alignment_score'] = avg
    return _take(out, np.array([q in winners for q in
                                bed['qname'].tolist()], bool))


@dataclasses.dataclass
class ClusterResult:
    cluster_bed: dict | None
    representative_bed: dict | None
    no_clusters: bool
    subgraphs: list | None = None
    # query_graph's path ('host', or the scale path's store) and sizes
    stats: dict = dataclasses.field(default_factory=dict)


def cluster_stage(bed: dict, chromosome_lengths: dict, cfg: ClusterConfig,
                  device: torch.device) -> ClusterResult:
    """The clustering block: bed columns (:func:`read_mappings`) and the
    BAM's contig lengths in, cluster and representative beds out.  Its
    steps are spans (``instrument.span``): ``prepare``, query_graph's
    (``tables``, ``enum_merge``, ``gate_order``, ``value_replay``,
    ``emit``), ``components``, ``assign`` and ``representatives``."""
    with span('prepare'):
        chromosome_mask = set()
        if cfg.cluster_mask:
            allowed = set(bed['chrom'].tolist())
            for item in cfg.cluster_mask:
                if item in allowed or item == 'subtelomere':
                    chromosome_mask.add(item)

        bed, chr_lengths, chromosome_mask, cmap = rename_chromosomes(
            bed, chromosome_lengths, chromosome_mask)
        if cfg.filter_false:
            bed = delete_false(bed)

        fillings = keep_fillings(bed)
        data = prepare_data(fillings, chromosome_mask, chr_lengths,
                            cfg.subtelomere_threshold)
        if cfg.filter_high_coverage:
            # the reference crashes on this flag; its documented intent:
            # drop intervals whose midpoint coverage exceeds the threshold
            data = filter_high_coverage(data, bed, chr_lengths,
                                        cfg.high_coverage_threshold)

    stats = {'path': 'host'}
    _, edges, node_pos = query_graph(
        data, cfg.overlap, list(cfg.jaccard_cutoffs), cfg.edge_threshold,
        cfg.qlen_diff, cfg.n_alignment_diff, cfg, device, stats)
    with span('components'):
        subgraphs = get_subgraphs(edges, node_pos, device)
    if len(subgraphs) == len(node_pos):       # true iff no edges
        return ClusterResult(None, None, True, subgraphs, stats)

    # every row gets its read's cluster and size; reads in no component
    # follow as singletons in first-row order.  As after pandas' left
    # merge, both columns turn float once a row had no component.
    with span('assign'):
        member = {}
        for num, comp in enumerate(subgraphs):
            for q in comp:
                member[q] = (num, len(comp))
        qn = bed['qname'].tolist()
        singles: dict = {}
        n_cluster = len(subgraphs)
        cluster = np.empty(len(qn), np.int64)
        n_reads = np.empty(len(qn), np.int64)
        for i, q in enumerate(qn):
            if q in member:
                cluster[i], n_reads[i] = member[q]
            else:
                cluster[i] = singles.setdefault(q, n_cluster + len(singles))
                n_reads[i] = 1
        if singles:
            cluster, n_reads = cluster.astype(np.float64), \
                n_reads.astype(np.float64)
        out = chrom_to_str({**bed, 'cluster': cluster, 'n_reads': n_reads},
                           cmap)
    with span('representatives'):
        representatives = choose_alignment(out)
    return ClusterResult(out, representatives, False, subgraphs, stats)
