"""Adversarial sweep of the capped walk's closed form against the exact walk.

Counterpart of ``fslr_tpu/tools/cap_sweep.py``.  The scale path of
clustering (ops/encounters.py, ops/capwalk.resolve_device) replays the
soft edge cap in closed form: every gated pair is valued at its first
encounter, whereas the reference's walk tests again a pair that a capped
break left unseen.  On capped frames the edge sets may differ; the sweep
measures how often the partition (cluster and size of every read) or the
representatives differ as well.

Each case draws fslr_tpu's cap-heavy frame (the draws of
``tests/test_reference_oracle.make_frame`` from ``default_rng(seed0 +
case)``: few groups of many members, noise reads, a cap of 3, 5 or 10)
and runs it through the port's cluster stage twice: on the scale path
(``device_enum_min_encounters=0``) and on the host path with the exact
capped replay (``exact_cap_replay=True``), which the port's tests hold to
fslr_tpu's host path and fslr_tpu's tests to the reference walk.  It
runs without pandas, networkx or JAX.

    python -m fslr_tpu_torch.tools.cap_sweep --cases 2000 [--seed0 1]
        [--device cuda|cpu]

prints fslr_tpu's JSON line at the end (cases, frames whose edge sets
differ, the largest symmetric difference, partition mismatches and their
first 20 seeds) and exits 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from fslr_tpu_torch.config import ClusterConfig
from fslr_tpu_torch.stages import cluster as C

# the oracle frames' chromosomes (tests/test_reference_oracle.CHR_LEN_NUM)
CHR_LEN_NUM = {1: 10_000_000, 2: 10_000_000, 3: 3_000_000}
COLUMNS = ('chrom', 'rstart', 'rend', 'qname', 'n_alignments', 'aln_size',
           'qstart', 'qend', 'strand', 'mapq', 'qlen', 'alignment_score',
           'inferred_by_primer', 'seq')


def make_frame(rng, n_groups=6, max_members=6, n_noise=8) -> dict:
    """The mappings-bed frame of tests/test_reference_oracle.make_frame,
    from the same draws, as numpy columns (numeric chromosome ids):
    recurrent breakpoint groups of jittered members (some reversed, some
    with an interval fewer) and noise reads, between two bread rows on
    chromosome 2; interval starts are then made unique."""
    rows = []

    def add_read(qname, segs):
        n = len(segs) + 2
        q = 0
        out = [(2, 8_000_000 + int(rng.integers(0, 1000)),
                8_000_500 + int(rng.integers(0, 1000)))]
        out += segs
        out.append((2, 8_100_000 + int(rng.integers(0, 1000)),
                    8_100_500 + int(rng.integers(0, 1000))))
        for (chrom, rs, re_) in out:
            ln = abs(re_ - rs)
            strand = '+' if rng.random() < 0.7 else '-'
            mapq = int(rng.integers(0, 61))
            score = float(rng.integers(10, 2000))
            rows.append((chrom, rs, re_, qname, n, ln, q, q + ln, strand,
                         mapq, 0, score, 0, ''))
            q += ln

    for g in range(n_groups):
        base = []
        for _ in range(int(rng.integers(1, 5))):
            chrom = int(rng.integers(1, 4))
            lo = int(rng.integers(600_000, 2_400_000))
            base.append((chrom, lo, lo + int(rng.integers(200, 2000))))
        for m in range(int(rng.integers(1, max_members + 1))):
            segs = []
            for (chrom, rs, re_) in base:
                j1 = int(rng.integers(-40, 41))
                j2 = int(rng.integers(-40, 41))
                if rng.random() < 0.5:     # reversed orientation rows
                    segs.append((chrom, re_ + j2, rs + j1))
                else:
                    segs.append((chrom, rs + j1, re_ + j2))
            if rng.random() < 0.25 and len(segs) > 1:
                segs = segs[:-1]           # vary n_alignments
            rng.integers(10, 2000)         # the oracle's unused read score
            add_read(f'g{g}m{m}.9_9.21q1F_17p6R', segs)

    for i in range(n_noise):
        segs = []
        for _ in range(int(rng.integers(0, 4))):    # 0: bread only
            chrom = int(rng.integers(1, 4))
            lo = int(rng.integers(550_000, 2_500_000))
            segs.append((chrom, lo, lo + int(rng.integers(150, 2500))))
        rng.integers(10, 2000)
        add_read(f'n{i}.9_9.{"False_False" if i % 3 else "21q1F_17p6R"}',
                 segs)

    cols = list(zip(*rows))
    bed = {}
    for name, col in zip(COLUMNS, cols):
        kind = type(col[0])
        bed[name] = (np.array(col, np.int64) if kind is int else
                     np.array(col, np.float64) if kind is float else
                     np.array(col, object))
    # unique interval-start keys: bump each start to one past the last
    start = np.minimum(bed['rstart'], bed['rend'])
    order = np.argsort(start, kind='stable')
    bump = np.zeros(len(start), np.int64)
    ss = start[order]
    for i in range(1, len(ss)):
        if ss[i] <= ss[i - 1]:
            bump[order[i]] = ss[i - 1] + 1 - ss[i]
            ss[i] = ss[i - 1] + 1
    fwd = bed['rstart'] <= bed['rend']
    bed['rstart'] = bed['rstart'] + np.where(fwd, bump, 0)
    bed['rend'] = bed['rend'] + np.where(fwd, 0, bump)
    return bed


def _partition(res):
    """{read: (cluster, size)} and the representatives' reads, or None
    when no cluster was found."""
    if res.no_clusters:
        return None
    bed = res.cluster_bed
    return ({q: (int(c), int(n)) for q, c, n in
             zip(bed['qname'], bed['cluster'], bed['n_reads'])},
            set(res.representative_bed['qname'].tolist()))


def sweep(cases: int, seed0: int, device: torch.device) -> list[dict]:
    """One record a case: its seed and cap, the symmetric difference of
    the exact and closed-form edge sets, and whether the partitions and
    representatives agree."""
    out = []
    chr_len = {f'chr{c}': n for c, n in CHR_LEN_NUM.items()}
    for case in range(cases):
        rng = np.random.default_rng(seed0 + case)
        frame = make_frame(rng, n_groups=int(rng.integers(1, 5)),
                           max_members=int(rng.integers(12, 40)),
                           n_noise=int(rng.integers(0, 10)))
        cap = int(rng.choice([3, 5, 10, 10, 10]))
        cfgs = (ClusterConfig(edge_threshold=cap, exact_cap_replay=True,
                              device_enum_min_encounters=1 << 62),
                ClusterConfig(edge_threshold=cap,
                              device_enum_min_encounters=0))
        data = C.prepare_data(C.keep_fillings(frame),
                              set(cfgs[0].cluster_mask), CHR_LEN_NUM,
                              cfgs[0].subtelomere_threshold)
        edges, parts = [], []
        for cfg in cfgs:
            _, e, _ = C.query_graph(
                data, cfg.overlap, list(cfg.jaccard_cutoffs),
                cfg.edge_threshold, cfg.qlen_diff, cfg.n_alignment_diff,
                cfg, device)
            edges.append({tuple(sorted(x)) for x in e})
            bed = {**frame, 'chrom': np.array(
                [f'chr{c}' for c in frame['chrom'].tolist()], object)}
            parts.append(_partition(C.cluster_stage(bed, chr_len, cfg,
                                                    device)))
        out.append(dict(seed=seed0 + case, edge_threshold=cap,
                        edge_sym_diff=len(edges[0] ^ edges[1]),
                        partition_ok=parts[0] == parts[1]))
    return out


def totals(records: list[dict]) -> dict:
    """fslr_tpu's summary line of a sweep."""
    bad = [r['seed'] for r in records if not r['partition_ok']]
    return {
        'cases': len(records),
        'edge_diff_frames': sum(r['edge_sym_diff'] > 0 for r in records),
        'max_edge_sym_diff': max((r['edge_sym_diff'] for r in records),
                                 default=0),
        'partition_mismatches': len(bad),
        'mismatch_seeds': bad[:20],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--cases', type=int, default=2000)
    ap.add_argument('--seed0', type=int, default=1)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    records = sweep(args.cases, args.seed0, torch.device(args.device))
    for r in records:
        if not r['partition_ok']:
            print(json.dumps({'case_seed': r['seed'],
                              'PARTITION_MISMATCH': True,
                              'edge_sym_diff': r['edge_sym_diff']}),
                  file=sys.stderr)
    line = totals(records)
    print(json.dumps(line))
    return 1 if line['partition_mismatches'] else 0


if __name__ == '__main__':
    raise SystemExit(main())
