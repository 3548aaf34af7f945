"""fslr_tpu_torch.ops.ssw against fslr_tpu.ops.ssw on the CPU.

Every DP value is an integer below 2^24 held in float32, so scores, ends
and lanes must be equal exactly, for both gap conventions, with N codes,
rows that score 0 and tied maxima.
"""

import numpy as np
import pytest
import torch

from fslr_tpu.config import ScoringConfig
from fslr_tpu.ops import ssw as jssw
from fslr_tpu_torch.ops import ssw as tssw
from tests.test_torch_env import port_config
from tests.oracles import mutate, random_seq

SCORINGS = [ScoringConfig(), ScoringConfig(gap_open_is_first_base=False)]
SC_IDS = ['ssw', 'bwa']


def _pairs(seed, B=24, T=512):
    """(q, t, qlens, tlens): random pairs with N codes, planted mutated
    copies, exact double copies (tied maxima), score-0 rows."""
    rng = np.random.default_rng(seed)
    q = np.full((B, 128), 4, np.uint8)
    t = np.full((B, T), 4, np.uint8)
    qlens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    for i in range(B):
        qq = random_seq(rng, int(rng.integers(5, 69)), 0.05)
        tt = random_seq(rng, int(rng.integers(5, T - 150)), 0.05)
        kind = i % 6
        if kind == 1:                              # planted, mutated
            p = int(rng.integers(0, len(tt)))
            tt = np.concatenate([tt[:p], mutate(rng, qq), tt[p:]])
        elif kind == 2:                            # two exact copies: tie
            tt = np.concatenate([tt[:20], qq, tt[20:40], qq, tt[40:]])
        elif kind == 3:                            # periodic query: lane ties
            qq = np.tile(np.array([0, 1], np.uint8), len(qq) // 2 + 1)[:30]
            tt = np.tile(np.array([0, 1], np.uint8), 100)
        elif kind == 4:                            # scores 0
            qq = np.zeros(20, np.uint8)
            tt = np.full(100, 3, np.uint8) if i % 12 == 4 else tt[:0]
        elif kind == 5 and i % 12 == 5:            # all-N query
            qq = np.full(30, 4, np.uint8)
        tt = tt[:T]
        q[i, :len(qq)] = qq
        t[i, :len(tt)] = tt
        qlens[i] = len(qq)
        tlens[i] = len(tt)
    return q, t, qlens, tlens


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _equal(jax_out, torch_out):
    for a, b in zip(jax_out, torch_out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize('sc', SCORINGS, ids=SC_IDS)
@pytest.mark.parametrize('seed', [0, 1])
def test_sw_max_matches_jax(sc, seed):
    q, t, qlens, tlens = _pairs(seed)
    _equal(jssw.sw_max(q, t, qlens, tlens, sc, backend='jax'),
           tssw.sw_max(*_torch(q, t, qlens, tlens), port_config(sc)))


def test_sw_max_matches_pallas_interpret():
    q, t, qlens, tlens = _pairs(2)
    _equal(jssw.sw_max(q, t, qlens, tlens, SCORINGS[0],
                       backend='pallas_interpret'),
           tssw.sw_max(*_torch(q, t, qlens, tlens), SCORINGS[0]))


def test_sw_max_narrow_queries():
    """Queries narrower than 128 columns are padded with N."""
    q, t, qlens, tlens = _pairs(3)
    q = q[:, :72]
    _equal(jssw.sw_max(q, t, qlens, tlens, SCORINGS[0], backend='jax'),
           tssw.sw_max(*_torch(q, t, qlens, tlens), SCORINGS[0]))


@pytest.mark.parametrize('sc', SCORINGS, ids=SC_IDS)
def test_sw_locate_matches_jax(sc):
    q, t, qlens, tlens = _pairs(4)
    want = jssw.sw_locate(q, t, qlens, tlens, sc, backend='jax')
    got = tssw.sw_locate(*_torch(q, t, qlens, tlens), port_config(sc))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(),
                                      err_msg=k)


def _packed_batch(seed, stride, n=12, T=700):
    rng = np.random.default_rng(seed)
    primers = [random_seq(rng, int(rng.integers(16, stride - 4)))
               for _ in range(3)]
    codes = primers + [3 - p[::-1] for p in primers]
    rows, row_of, seg_of = tssw.pack_queries(codes, stride)
    j_rows, j_row_of, j_seg_of = jssw.pack_queries(codes, stride)
    np.testing.assert_array_equal(rows, j_rows)
    np.testing.assert_array_equal(row_of, j_row_of)
    np.testing.assert_array_equal(seg_of, j_seg_of)
    q = rows[np.arange(n) % len(rows)]
    t = np.full((n, T), 4, np.uint8)
    tlens = np.zeros(n, np.int32)
    for r in range(n):
        tt = random_seq(rng, int(rng.integers(0, T - 60)), 0.03)
        if r % 3 == 0:
            p = int(rng.integers(0, len(tt) + 1))
            c = mutate(rng, codes[r % len(codes)], sub=0.08, indel=0.04)
            tt = np.concatenate([tt[:p], c, tt[p:]])
        elif r % 3 == 1:           # adjacent primers: no cross-segment path
            tt = np.concatenate([tt[:50], codes[0], codes[1], tt[50:]])
        tt = tt[:T]
        t[r, :len(tt)] = tt
        tlens[r] = len(tt)
    return q, t, tlens


@pytest.mark.parametrize('sc', SCORINGS, ids=SC_IDS)
@pytest.mark.parametrize('stride', [32, 64])
def test_sw_max_packed_matches_jax(sc, stride):
    q, t, tlens = _packed_batch(5, stride)
    _equal(jssw.sw_max_packed(q, t, tlens, sc, stride, backend='jax'),
           tssw.sw_max_packed(*_torch(q, t, tlens), port_config(sc), stride))


def test_sw_max_packed_matches_pallas_interpret():
    q, t, tlens = _packed_batch(6, 32, n=2, T=512)
    _equal(jssw.sw_max_packed(q, t, tlens, SCORINGS[0], 32,
                              backend='pallas_interpret'),
           tssw.sw_max_packed(*_torch(q, t, tlens), SCORINGS[0], 32))


def test_pack_queries_rejects_long_query():
    with pytest.raises(ValueError):
        tssw.pack_queries([np.zeros(40, np.uint8)], 32)


def test_unsupported_device_raises():
    q, t, qlens, tlens = (x.to('meta') for x in _torch(*_pairs(0, B=2)))
    with pytest.raises(ValueError, match='unsupported device'):
        tssw.sw_max(q, t, qlens, tlens, SCORINGS[0])
