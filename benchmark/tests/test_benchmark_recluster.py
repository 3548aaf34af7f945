"""The cell that clusters an earlier run's mappings (configuration
``tf2p_recluster``, mix ``dup700_near``): the groups planted beside each
other, the mappings and BAM header written for the program, the
comparison of ``judge_clusters.py`` on hand-made beds, and what it reads
on the program, on the control and on each fault the cell can have, at a
size a test run holds (on the CPU, or the card with the ``cuda`` marker).

* control ``overlap_half``: the clustering's reciprocal overlap at 0.5;
* half of the batch left out: the clustering reads every other read;
* an answer altered where it is produced: each cluster's representative
  the read of the lowest mean score.

A step that returns its state unchanged and the exchange between chips
do not exist in this one-card cell."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark import control, gen, judge_clusters, run

CAUGHT = {'overlap_half': 'mixed_clusters', 'half_rows': 'cluster_rows',
          'lowest_representative': 'representatives'}


def _cell(reads=1500, group=100):
    with open(os.path.join(run.HERE, 'configs', 'tf2p_recluster.json')) as fh:
        cfg = json.load(fh)
    cfg['name'] = 'test_' + cfg['name']
    cfg['contigs'] = [[n, 3_000_000 + 20_000 * i]
                      for i, (n, _) in enumerate(cfg['contigs'])]
    with open(os.path.join(run.HERE, 'mixes', 'dup700_near.json')) as fh:
        mix = json.load(fh)
    mix.update(reads_per_sample=reads, samples=1, group_size=group)
    return cfg, mix


@pytest.fixture(autouse=True)
def _cache(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(run, 'CACHE', str(tmp_path_factory.getbasetemp()
                                          / 'bench_cache'))


@pytest.fixture
def sample(tmp_path):
    cfg, mix = _cell()
    path = run.reference_fasta(cfg)
    s = gen.make_sample(cfg, mix, gen.Reference(cfg, path), 2**40 + 9,
                        mix['reads_per_sample'])
    return cfg, mix, s


def test_near_groups_pair_alike_groups():
    nfill = np.array([1, 2, 0, 1, 2, 2, 1, 1, 2])
    near = gen.near_groups({'near_share': 0.5}, nfill)
    assert len(near) == 2                       # half of 8 complex, in pairs
    assert all(a < b and nfill[a] == nfill[b] for b, a in near.items())
    assert gen.near_groups({}, nfill) == {}


def test_near_fillings_lie_beside_their_partners(sample):
    """Fillings of two groups overlap only where the second group was
    planted beside the first: as long, moved by 30-45% of that."""
    cfg, mix, s = sample
    sg = s['segs']
    groups: dict = {}
    for i in np.nonzero(sg['kind'] == gen.FILLING)[0]:
        g = int(s['group'][sg['read'][i]])
        groups.setdefault(g, set()).add((int(sg['contig'][i]),
                                         int(sg['rstart'][i]),
                                         int(sg['length'][i])))
    pairs = 0
    for g, segs in groups.items():
        for h, other in groups.items():
            if h <= g:
                continue
            for c1, s1, n1 in segs:
                for c2, s2, n2 in other:
                    if c1 == c2 and s1 < s2 + n2 and s2 < s1 + n1:
                        assert n1 == n2 and 0.29 <= abs(s1 - s2) / n1 <= 0.46
                        pairs += 1
    assert pairs >= 1


def test_same_groups_for_every_seed(sample):
    """Every seed plants as many groups with each number of fillings, and
    as many pairs beside each other."""
    cfg, mix, _ = sample
    ref = gen.Reference(cfg, run.reference_fasta(cfg))
    seen = []
    for seed in (1, 2**33 + 5):
        s = gen.make_sample(cfg, mix, ref, seed, mix['reads_per_sample'])
        fills = np.bincount(s['segs']['read'][
            s['segs']['kind'] == gen.FILLING], minlength=len(s['names']))
        fused = np.nonzero(s['group'] >= 0)[0]
        _, first = np.unique(s['group'][fused], return_index=True)
        nfill = fills[fused[first]]
        seen.append((sorted(nfill.tolist()),
                     len(gen.near_groups(mix, nfill))))
    assert seen[0] == seen[1] and seen[0][1] >= 1


def test_mappings_are_the_planted_segments(sample, tmp_path):
    cfg, mix, s = sample
    t = gen.write_mappings(cfg, s, str(tmp_path), 7)
    sg = s['segs']
    read = t['read']
    assert np.all(np.diff(read) >= 0)
    cats = s['category'][read]
    assert set(cats.tolist()) == {0, 1}
    for r in np.unique(read)[:50]:
        rows = np.nonzero(read == r)[0]
        planted = np.nonzero(sg['read'] == r)[0]
        planted = planted[np.argsort(sg['qstart'][planted])]
        assert len(rows) == len(planted) == t['n_alignments'][rows[0]]
        assert np.all(np.abs(t['qstart'][rows] - sg['qstart'][planted])
                      <= gen.JITTER)
        assert np.all(np.abs(t['rstart'][rows] - 1 - sg['rstart'][planted])
                      <= gen.JITTER)
    from fslr_tpu_torch.io import bam
    from fslr_tpu_torch.stages import cluster
    lengths = bam.get_chromosome_lengths(str(tmp_path / 'S.bwa_dodi.bam'))
    assert lengths == {n: ln for n, ln in cfg['contigs']}
    bed = cluster.read_mappings(str(tmp_path / 'S.mappings.bed'))
    assert bed['qname'].tolist() == t['qname'].tolist()
    assert np.array_equal(bed['rstart'], t['rstart'])


def _table():
    """Two planted groups of two reads (fillings at 600 kb and 700 kb of
    a 2 Mbp contig) and a read of no group whose filling lies in the
    masked subtelomere, each read: bread, filling, bread."""
    rows = []
    for r, (g, start, score) in enumerate([(0, 600_000, 10), (0, 600_004, 30),
                                           (1, 700_000, 20), (1, 700_003, 20),
                                           (-1, 1_600_000, 5)]):
        for k, (a, sc) in enumerate([(10, 1), (start, score), (1_999_000, 1)]):
            rows.append((r, 'c1', a, a + 500, f'q{r}.x.L', sc, 100 * k,
                         100 * k + 90))
    read, chrom, rs, re_, qn, sc, qs, qe = zip(*rows)
    table = {'read': np.array(read), 'chrom': np.array(chrom, object),
             'rstart': np.array(rs), 'rend': np.array(re_),
             'qname': np.array(qn, object),
             'alignment_score': np.array(sc), 'qstart': np.array(qs),
             'qend': np.array(qe)}
    sample = {'maps': table, 'group': np.array([0, 0, 1, 1, -1])}
    return {'contigs': [['c1', 2_000_000]]}, sample


def _write(tmp_path, sample, cluster, reps):
    t = sample['maps']
    cols = judge_clusters.COMPARED
    n_of = {c: list(cluster).count(c) for c in cluster}
    cid = [cluster[r] for r in t['read']]
    for name, keep in (('cluster', [True] * len(cid)),
                       ('representative', [r in reps for r in t['read']])):
        with open(tmp_path / f'S.mappings.{name}.bed', 'w') as fh:
            fh.write('\t'.join(cols + ('cluster', 'n_reads')) + '\n')
            for i in np.nonzero(keep)[0]:
                vals = [str(t[c][i]) for c in cols]
                fh.write('\t'.join(vals + [f'{cid[i]}.0',
                                           f'{n_of[cid[i]]}.0']) + '\n')
    return str(tmp_path / 'S')


def test_judge_reads_a_sound_clustering(tmp_path):
    cfg, sample = _table()
    base = _write(tmp_path, sample, [0, 0, 1, 1, 2], {1, 2, 4})
    found, seen = judge_clusters.judge_sample(cfg, sample, base)
    assert found == dict.fromkeys(judge_clusters.LIMITS, 0), found
    assert seen['multi_read_clusters'] == 2


@pytest.mark.parametrize('cluster,reps,key,value', [
    ([0, 0, 0, 0, 1], {1, 4}, 'mixed_clusters', 1),
    ([0, 1, 2, 2, 3], {0, 1, 2, 4}, 'split_groups', 1),
    ([0, 0, 1, 1, 2], {0, 2, 4}, 'representatives', 1),
    ([0, 0, 1, 1, 1], {1, 2}, 'cluster_rows', 1),
])
def test_judge_counts_each_fault(tmp_path, cluster, reps, key, value):
    cfg, sample = _table()
    base = _write(tmp_path, sample, cluster, reps)
    found, _ = judge_clusters.judge_sample(cfg, sample, base)
    assert found[key] == value, found


def test_judge_counts_rows_that_differ_or_are_missing(tmp_path):
    cfg, sample = _table()
    base = _write(tmp_path, sample, [0, 0, 1, 1, 2], {1, 2, 4})
    with open(base + '.mappings.cluster.bed') as fh:
        lines = fh.readlines()
    lines[2] = lines[2].replace('600000', '600001', 1)
    with open(base + '.mappings.cluster.bed', 'w') as fh:
        fh.writelines(lines[:-1])
    found, _ = judge_clusters.judge_sample(cfg, sample, base)
    assert found['cluster_rows'] >= 2, found


def _run(device, alter=None, reads=1500, group=100):
    cfg, mix = _cell(reads, group)

    def scale(c):
        # the device scale path from 1,000 encounters, as the cell takes it
        c = c.replace(cluster=dataclasses.replace(
            c.cluster, device_enum_min_encounters=1000))
        return alter(c) if alter else c
    result, lines, _ = run.run_cell(
        cfg, mix, ['reads_per_s', 'setup_s'], [], 2**35 + 21, 0.01, False,
        device, alter=scale)
    return result, {k: v['value'] for k, v in result['compared'].items()}, \
        lines


def _check(case, device, monkeypatch):
    if case == 'sound':
        result, got, lines = _run(device)
        assert result['correct'] and result['attempted'] == 1, got
        assert set(got) == set(judge_clusters.LIMITS)
        assert "clustering paths ['in-HBM']" in '\n'.join(lines)
        return
    alter = control.CONTROLS.get(case)
    if case in control.FAULTS:
        control.FAULTS[case](monkeypatch.setattr)
    result, got, _ = _run(device, alter)
    assert not result['correct'] and got[CAUGHT[case]] > 0, got


CASES = ['sound', 'overlap_half', 'half_rows', 'lowest_representative']


@pytest.mark.parametrize('case', CASES)
def test_recluster_correct_on_cpu(case, monkeypatch):
    _check(case, torch.device('cpu'), monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES)
def test_recluster_correct_on_the_card(case, card, monkeypatch):
    _check(case, card, monkeypatch)
