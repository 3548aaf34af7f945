"""The comparison that decides ``correct`` where a configuration clusters
an earlier run's mappings (``"input": "mappings"``): the cluster and
representative beds that each window sample wrote, judged by what they
say, against the mappings that ``gen.mappings`` made and the breakpoint
groups planted in them.  Plain NumPy and ``csv``; nothing here imports the
program or reads a file it made other than the beds under judgement.

fslr's clustering drops each read's first and last alignment (the
primer-side breads) and every alignment within 500 kb of the end of a
contig longer than 1 Mbp (``--cluster-mask subtelomere``); two reads join
when their remaining alignments overlap reciprocally by ``--overlap``
(0.8) or more, and a cluster is a connected set of such reads.  The reads
of a planted group share every segment, their ends at most
``gen.JITTER`` bases apart; groups planted beside each other share none
at that overlap.  So over each sample:

* ``cluster_rows``: a row of ``mappings.cluster.bed`` that is not the
  input's row at its place (contig, positions, name, query span, score),
  a row missing or added, a read whose rows carry two cluster ids, a row
  whose ``n_reads`` is not the number of reads of its cluster, and a read
  with nothing left to cluster that shares a cluster;
* ``mixed_clusters``: a cluster that holds reads of more than one planted
  group (a read of no group counts as a group of its own), counted once
  for each group past the first;
* ``split_groups``: a planted group whose reads with something left to
  cluster lie in more than one cluster, counted once for each cluster past
  the first;
* ``representatives``: a cluster whose rows in
  ``mappings.representative.bed`` are not every row of its read with the
  highest mean alignment score (the first such read on ties).

Each number counts faults: the limit of each is 0.
"""

from __future__ import annotations

import csv
import os

import numpy as np

LIMITS = {'cluster_rows': 0, 'mixed_clusters': 0, 'split_groups': 0,
          'representatives': 0}
SUBTELOMERE, LONG_CONTIG = 500_000, 1_000_000
COMPARED = ('chrom', 'rstart', 'rend', 'qname', 'qstart', 'qend',
            'alignment_score')


def read_table(path: str) -> dict:
    """A tab-separated bed with a header as columns of strings (empty
    where the file is absent: a run that found no cluster writes none)."""
    if not os.path.exists(path):
        return {}
    with open(path, newline='') as fh:
        rows = list(csv.reader(fh, delimiter='\t'))
    return {h: list(c) for h, c in zip(rows[0], zip(*rows[1:]))} \
        if len(rows) > 1 else {h: [] for h in rows[0]}


def clusterable(config: dict, table: dict) -> np.ndarray:
    """Per read of the table's rows: whether anything is left to cluster
    once its first and last rows and the masked ones are dropped."""
    read = np.asarray(table['read'])
    n = len(read)
    rows = np.arange(n)
    first = np.ones(n, bool)
    last = np.ones(n, bool)
    first[1:] = read[1:] != read[:-1]
    last[:-1] = read[1:] != read[:-1]
    lengths = {c: int(ln) for c, ln in config['contigs']}
    a = np.minimum(table['rstart'], table['rend'])
    b = np.maximum(table['rstart'], table['rend'])
    clen = np.array([lengths[c] for c in table['chrom']], np.int64)
    masked = (clen > LONG_CONTIG) & ((a < SUBTELOMERE)
                                     | (clen - b < SUBTELOMERE))
    left = ~first & ~last & ~masked
    out = np.zeros(int(read.max()) + 1 if n else 0, bool)
    out[read[rows[left]]] = True
    return out


def judge_sample(config: dict, sample: dict, base: str) -> tuple:
    """(faults, what was looked at) of one sample's beds."""
    table = sample['maps']
    found = dict.fromkeys(LIMITS, 0)
    cb = read_table(f'{base}.mappings.cluster.bed')
    rb = read_table(f'{base}.mappings.representative.bed')
    n_in = len(table['qname'])
    n_out = len(cb.get('qname', []))
    qread = dict(zip(table['qname'].tolist(), table['read'].tolist()))
    bad = abs(n_in - n_out)
    m = min(n_in, n_out)
    wrong = np.zeros(m, bool)
    for c in COMPARED:
        want = np.asarray(table[c][:m]).astype(str)
        got = np.asarray(cb.get(c, [''] * m)[:m], dtype=str)
        wrong |= want != got
    bad += int(wrong.sum())

    # each read's cluster, by what the bed says
    rid = np.array([qread.get(q, -1) for q in cb.get('qname', [])],
                   np.int64)
    cid = np.array([int(float(x)) for x in cb.get('cluster', [])], np.int64)
    size = np.array([int(float(x)) for x in cb.get('n_reads', [])],
                    np.int64)
    bad += int((rid < 0).sum())
    ok = rid >= 0
    of_read: dict = {}
    for r, c in zip(rid[ok].tolist(), cid[ok].tolist()):
        of_read.setdefault(r, set()).add(c)
    bad += sum(len(s) > 1 for s in of_read.values())
    cluster = {r: min(s) for r, s in of_read.items()}
    members: dict = {}
    for r, c in cluster.items():
        members.setdefault(c, []).append(r)
    bad += int(sum(size[i] != len(members.get(int(cid[i]), ()))
                   for i in np.nonzero(ok)[0].tolist()))
    left = clusterable(config, table)
    bad += sum(1 for r, c in cluster.items()
               if len(members[c]) > 1 and not left[r])
    bad += sum(1 for r in set(table['read'].tolist()) if r not in cluster)
    found['cluster_rows'] = bad

    group = sample['group']
    for c, reads in members.items():
        if len(reads) > 1:
            owners = {int(group[r]) if group[r] >= 0 else -1 - r
                      for r in reads}
            found['mixed_clusters'] += len(owners) - 1
    by_group: dict = {}
    for r in np.nonzero(left)[0].tolist():
        if group[r] >= 0 and r in cluster:
            by_group.setdefault(int(group[r]), set()).add(cluster[r])
    found['split_groups'] = sum(len(s) - 1 for s in by_group.values())

    # the representative of each cluster: the read of the highest mean
    # score, the first in the file on ties
    read = table['read']
    score = np.asarray(table['alignment_score'], np.float64)
    mean = np.bincount(read, score, minlength=len(group)) / np.maximum(
        np.bincount(read, minlength=len(group)), 1)
    n_rows = np.bincount(read, minlength=len(group))
    first_row = {}
    for i, r in enumerate(read.tolist()):
        first_row.setdefault(r, i)
    rep_rows: dict = {}
    for q, c in zip(rb.get('qname', []), rb.get('cluster', [])):
        key = (int(float(c)), qread.get(q, -1))
        rep_rows[key] = rep_rows.get(key, 0) + 1
    rep_of: dict = {}
    for (c, r), k in rep_rows.items():
        rep_of.setdefault(c, []).append((r, k))
    for c, reads in members.items():
        win = min(reads, key=lambda r: (-mean[r], first_row[r]))
        if rep_of.get(c) != [(win, int(n_rows[win]))]:
            found['representatives'] += 1
    found['representatives'] += sum(1 for c in rep_of if c not in members)
    seen = {'rows': n_in, 'clusters': len(members),
            'groups': len(by_group),
            'multi_read_clusters': sum(len(v) > 1 for v in members.values())}
    return found, seen


def judge_window(config: dict, runs: list) -> tuple[dict, dict]:
    """Faults summed over the window's samples ``runs``, each (index,
    sample, base of its outputs), and what each sample looked at."""
    found = dict.fromkeys(LIMITS, 0)
    where = {}
    for index, sample, base in runs:
        f, seen = judge_sample(config, sample, base)
        for k in found:
            found[k] += f[k]
        where[index] = {**seen, **{k: v for k, v in f.items() if v}}
    return found, where
