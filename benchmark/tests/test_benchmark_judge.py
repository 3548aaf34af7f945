"""The comparison's own arithmetic (benchmark/judge.py) on hand-made
records: a CIGAR's score, the plain DP, and one read's records built from
its planted truth, sound and then broken one way at a time."""

import json
import os

import numpy as np
import pytest

from benchmark import gen, judge

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, I, D, S, H = 0, 1, 2, 4, 5


def _rec(lens, ops, **kw):
    r = dict(qname='r.1.0_1.0.aF_bR', rid=0, pos=0, mapq=60, flag=0,
             lens=np.array(lens, np.int64), ops=np.array(ops, np.int64),
             seq=np.zeros(0, np.uint8), AS=0)
    r.update(kw)
    return r


def test_path_score_and_plain_dp():
    rng = np.random.default_rng(3)
    r = rng.integers(0, 4, 60, dtype=np.uint8)
    assert judge.path_score(r, r, np.array([60]), np.array([M])) == 120
    assert judge.global_best(r, r) == 120
    q = r.copy()
    q[30] = (q[30] + 1) % 4
    assert judge.path_score(q, r, np.array([60]), np.array([M])) == 115
    assert judge.global_best(q, r) == 115
    q = np.concatenate([r[:20], r[23:]])          # 3 bases deleted
    cig = (np.array([20, 3, 37]), np.array([M, D, M]))
    assert judge.path_score(q, r, *cig) == 2 * 57 - (5 + 2 * 3)
    assert judge.global_best(q, r) == 2 * 57 - (5 + 2 * 3)
    q = np.concatenate([r[:20], [0, 1], r[20:]])  # 2 bases inserted
    cig = (np.array([20, 2, 40]), np.array([M, I, M]))
    assert judge.path_score(q, r, *cig) == 2 * 60 - (5 + 2 * 2)
    assert judge.global_best(q, r) >= judge.path_score(q, r, *cig)
    # a path that is not the best scores below the DP
    cig = (np.array([20, 2, 2, 38]), np.array([M, D, I, M]))
    q = r.copy()
    assert judge.path_score(q, r, *cig) < judge.global_best(q, r)


def test_cigar_parts():
    p = judge.cigar_parts(_rec([5, 10, 2, 7, 3], [S, M, D, M, H]))
    assert (p['lead'], p['trail'], p['qspan'], p['rspan']) == (5, 3, 17, 19)
    assert p['known'] and not p['clip_inside'] and p['n_match'] == 2
    p = judge.cigar_parts(_rec([3600, 914], [H, H]))
    assert p['n_match'] == 0 and p['qspan'] == 0
    assert judge.cigar_parts(_rec([4, 5, 4], [M, S, M]))['clip_inside']


def test_planted_label():
    assert gen.planted_label(['a', 'b'], (0, 1)) == 'aF_bR'
    assert gen.planted_label(['a', 'b'], (1, -1)) == 'bF_False'


@pytest.fixture(scope='module')
def made(tmp_path_factory):
    with open(os.path.join(HERE, 'configs', 'tf2p.json')) as fh:
        cfg = json.load(fh)
    cfg['contigs'] = [[n, 400_000] for n, _ in cfg['contigs']]
    with open(os.path.join(HERE, 'mixes', 'dup700.json')) as fh:
        mix = json.load(fh)
    mix.update(error_rate=0.0, group_size=5, subtelomere_bp=100_000)
    path = str(tmp_path_factory.mktemp('ref') / 'ref.fa')
    gen.write_reference(cfg, path)
    ref = gen.Reference(cfg, path)
    return cfg, ref, gen.make_sample(cfg, mix, ref, 2**33 + 1, 60)


def _truth_records(cfg, ref, s, i):
    """Exact records of error-free read ``i``, its primary forward."""
    segs = s['segs']
    codes = s['codes'][s['offs'][i]:s['offs'][i + 1]]
    n = len(codes)
    recs = []
    for j in np.flatnonzero(segs['read'] == i):
        q0, q1 = int(segs['qstart'][j]), int(segs['qend'][j])
        rev = bool(segs['reverse'][j])
        lead, trail = (n - q1, q0) if rev else (q0, n - q1)
        recs.append(_rec([lead, q1 - q0, trail], [H, M, H],
                         rid=int(segs['contig'][j]),
                         pos=int(segs['rstart'][j]),
                         flag=16 | 2048 if rev else 2048,
                         AS=2 * (q1 - q0)))
    recs[0]['ops'][[0, 2]] = S
    recs[0]['flag'] &= ~2048
    prim = recs[0]
    recs[0]['seq'] = gen.revcomp(codes) if prim['flag'] & 16 else codes
    rows = []
    for r in recs:
        p = judge.cigar_parts(r)
        q0, q1 = p['lead'], p['lead'] + p['qspan']
        if (r['flag'] ^ prim['flag']) & 16:
            q0, q1 = n - q1, n - q0
        rows.append([ref.names[r['rid']], str(r['pos'] + 1),
                     str(r['pos'] + p['rspan']), 'x', str(len(recs)),
                     str(q1 - q0), str(q0), str(q1),
                     '-' if r['flag'] & 16 else '+', str(r['mapq']), str(n),
                     str(r['AS'])])
    return recs, rows


def _judge(cfg, ref, s, i, recs, rows):
    read = judge._Read(s, i, recs)
    return judge.judge_read(read, s, i, ref, s['segs'], rows,
                            judge._primer_spans(cfg, s, i))['out']


def test_records_of_the_truth_are_sound_and_each_fault_shows(made):
    cfg, ref, s = made
    fus = np.flatnonzero(s['category'] == 0)[:6]
    for i in fus:
        recs, rows = _truth_records(cfg, ref, s, int(i))
        assert not any(_judge(cfg, ref, s, int(i), recs, rows).values())

        recs, rows = _truth_records(cfg, ref, s, int(i))
        recs[1]['AS'] += 1                             # a score altered
        assert _judge(cfg, ref, s, int(i), recs, rows)['bad_records'] == 1

        recs, rows = _truth_records(cfg, ref, s, int(i))
        n = len(recs[0]['seq'])
        recs.append(_rec([n - 10, 10], [H, H], AS=22))  # no base aligned
        out = _judge(cfg, ref, s, int(i), recs, rows)
        assert out['bad_records'] == 1 and out['bed_rows'] == 1

        recs, rows = _truth_records(cfg, ref, s, int(i))
        recs[1]['pos'] += 5000                         # moved elsewhere
        out = _judge(cfg, ref, s, int(i), recs, rows)
        assert out['missed_segments'] == 1 and out['bed_rows'] == 1

        recs, rows = _truth_records(cfg, ref, s, int(i))
        recs[0]['seq'] = recs[0]['seq'][80:]           # trimmed into it
        assert _judge(cfg, ref, s, int(i), recs, rows)['bad_records'] >= 1


def _scalar_local(q, t):
    """Cell by cell: the best local score ending at each target column."""
    m, n = len(q), len(t)
    neg = -10**9
    h = [[0] * (n + 1) for _ in range(m + 1)]
    e = [[neg] * (n + 1) for _ in range(m + 1)]
    f = [[neg] * (n + 1) for _ in range(m + 1)]
    best = [0] * n
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            e[i][j] = max(h[i][j - 1] - 5, e[i][j - 1] - 2)
            f[i][j] = max(h[i - 1][j] - 5, f[i - 1][j] - 2)
            s = 2 if q[i - 1] == t[j - 1] and t[j - 1] < 4 else -3
            h[i][j] = max(0, h[i - 1][j - 1] + s, e[i][j], f[i][j])
            best[j - 1] = max(best[j - 1], h[i][j])
    return best


def _scalar_global(q, r):
    """Cell by cell: the best global score, a gap of g costing 5 + 2g."""
    m, n = len(q), len(r)
    neg = -10**9
    h = [[neg] * (n + 1) for _ in range(m + 1)]
    e = [[neg] * (n + 1) for _ in range(m + 1)]
    f = [[neg] * (n + 1) for _ in range(m + 1)]
    h[0][0] = 0
    for j in range(1, n + 1):
        h[0][j] = e[0][j] = -(5 + 2 * j)
    for i in range(1, m + 1):
        h[i][0] = f[i][0] = -(5 + 2 * i)
        for j in range(1, n + 1):
            e[i][j] = max(h[i][j - 1] - 7, e[i][j - 1] - 2)
            f[i][j] = max(h[i - 1][j] - 7, f[i - 1][j] - 2)
            s = 2 if q[i - 1] == r[j - 1] else -3
            h[i][j] = max(h[i - 1][j - 1] + s, e[i][j], f[i][j])
    return h[m][n]


@pytest.mark.parametrize('seed', range(6))
def test_plain_dps_equal_cell_by_cell(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        q = rng.integers(0, 4, rng.integers(3, 14)).astype(np.uint8)
        t = rng.integers(0, 5, rng.integers(5, 40)).astype(np.uint8)
        k = min(len(q), len(t) - 5)
        t[5:5 + k] = q[:k]
        assert judge.local_best(q, t).tolist() == _scalar_local(q, t)
        r = rng.integers(0, 4, rng.integers(1, 16)).astype(np.uint8)
        assert judge.global_best(q, r) == _scalar_global(q, r)


def test_concatemer_rule(made):
    cfg, ref, s = made
    cat = np.array(gen.CATEGORIES)[s['category']]
    reads = np.flatnonzero(np.isin(cat, ('fusion', 'concatemer')))
    hit = judge.concatemer_hits(cfg, s, reads)
    # error-free concatemers carry their inner oligos whole (the 21q1
    # oligo lies inside its target; 17p6's only in part)
    assert hit[cat[reads] == 'concatemer'].any()
    assert not hit[cat[reads] == 'fusion'].any()
