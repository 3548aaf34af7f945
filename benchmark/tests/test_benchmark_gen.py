"""The traffic generator (benchmark/gen.py)."""

import gzip
import json
import os

import numpy as np
import pytest

from benchmark import gen

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config():
    with open(os.path.join(HERE, 'configs', 'tf2p.json')) as fh:
        cfg = json.load(fh)
    cfg['contigs'] = [[n, 1_100_000 + 10_000 * i]
                      for i, (n, _) in enumerate(cfg['contigs'])]
    return cfg


def _mix(name='dup700', **kw):
    with open(os.path.join(HERE, 'mixes', f'{name}.json')) as fh:
        mix = json.load(fh)
    mix.update(kw)
    return mix


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    cfg = _config()
    path = str(tmp_path_factory.mktemp('ref') / 'ref.fa')
    gen.write_reference(cfg, path)
    return cfg, path


def test_reference_is_the_contigs(ref):
    cfg, path = ref
    r = gen.Reference(cfg, path)
    with open(path) as fh:
        text = fh.read()
    for i, (name, n) in enumerate(cfg['contigs']):
        codes = gen.contig_codes(cfg, i)
        assert len(codes) == n
        assert f'>{name}\n' in text
        for start, k in ((0, 61), (59, 1), (n - 121, 121), (12_345, 3_000)):
            assert np.array_equal(r.segment(i, start, k),
                                  codes[start:start + k])


def test_same_seed_same_bytes(ref, tmp_path):
    cfg, path = ref
    r = gen.Reference(cfg, path)
    mix = _mix(group_size=20)
    a = gen.make_sample(cfg, mix, r, 2**40 + 3, 300)
    b = gen.make_sample(cfg, mix, r, 2**40 + 3, 300)
    c = gen.make_sample(cfg, mix, r, 2**40 + 4, 300)
    pa = gen.write_sample(a, str(tmp_path / 'a'), 100)
    pb = gen.write_sample(b, str(tmp_path / 'b'), 100)
    assert [open(x, 'rb').read() for x in pa] == \
        [open(x, 'rb').read() for x in pb]
    assert a['names'] != c['names']
    # another seed: other reads, the same multiset of planted lengths
    assert not np.array_equal(a['codes'][:1000], c['codes'][:1000])


def test_categories_groups_and_files(ref, tmp_path):
    cfg, path = ref
    r = gen.Reference(cfg, path)
    mix = _mix(group_size=20)
    n = 1000
    s = gen.make_sample(cfg, mix, r, 77, n)
    want = gen.category_counts(mix, n)
    got = np.bincount(s['category'], minlength=len(gen.CATEGORIES))
    assert dict(zip(gen.CATEGORIES, got.tolist())) == want
    fus = s['group'][s['category'] == 0]
    sizes = np.bincount(fus)
    assert len(sizes) == -(-want['fusion'] // mix['group_size'])
    assert sizes.max() - sizes.min() <= 1
    assert (s['group'][s['category'] != 0] == -1).all()
    lens = np.diff(s['offs'])
    assert (lens[s['category'] == gen.CATEGORIES.index('short')]
            < 220).all()
    paths = gen.write_sample(s, str(tmp_path / 'fq'), 400)
    counts = []
    for p in paths:
        assert p.endswith('.fastq.gz')
        with gzip.open(p, 'rt') as fh:
            lines = fh.read().splitlines()
        counts.append(len(lines) // 4)
        assert all(x.startswith('@') for x in lines[::4])
        assert all(len(x) == len(y) for x, y in zip(lines[1::4],
                                                   lines[3::4]))
    assert counts == [400, 400, 200]


def test_error_rate_and_split():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 400_000, dtype=np.uint8)
    offs = np.array([0, 150_000, 400_000])
    new, noffs, _ends = gen._mutate(rng, codes, offs, 0.05, [1, 1, 1])
    assert noffs[-1] == len(new)
    # insertions and deletions balance; substitutions change ~1.67%
    assert abs(len(new) - len(codes)) < 1500
    same = gen._mutate(np.random.default_rng(5), codes, offs, 0.0,
                       [1, 1, 1])[0]
    assert np.array_equal(same, codes)


def test_strata_same_multiset_any_seed():
    a = gen.strata(np.random.default_rng(1), 19, 300, 3000)
    b = gen.strata(np.random.default_rng(2), 19, 300, 3000)
    assert sorted(a) == sorted(b) and list(a) != list(b)


def test_planted_segments_are_the_reads(ref):
    """Without errors every planted segment is its reference segment (or
    its reverse complement) where the truth says; with them, where the
    errors moved it, within the indels' drift."""
    cfg, path = ref
    r = gen.Reference(cfg, path)
    for rate in (0.0, 0.05):
        s = gen.make_sample(cfg, _mix(group_size=20, error_rate=rate), r,
                            2**36 + 5, 300)
        sg = s['segs']
        assert set(sg) == set(gen.SEG_FIELDS)
        cats = s['category'][sg['read']]
        assert (cats != gen.CATEGORIES.index('short')).sum() > 600
        for j in range(len(sg['read'])):
            o = s['offs'][sg['read'][j]]
            got = s['codes'][o + sg['qstart'][j]:o + sg['qend'][j]]
            want = r.segment(sg['contig'][j], sg['rstart'][j],
                             sg['length'][j])
            if sg['reverse'][j]:
                want = gen.revcomp(want)
            if rate == 0:
                assert np.array_equal(got, want)
            else:
                assert abs(len(got) - len(want)) <= 0.05 * len(want) + 8
        p = s['primers']
        assert ((p[:, 0] >= 0) & (p[:, 0] < len(cfg['primers']))).all()
        one = s['category'] == gen.CATEGORIES.index('one_primer')
        assert (p[one, 1] == -1).all() and (p[~one & (s['category'] < 4),
                                              1] >= 0).all()
