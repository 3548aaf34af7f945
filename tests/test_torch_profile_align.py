"""fslr_tpu_torch.ops.profile_align (kernel #6's plain version and the
walk) against fslr_tpu.ops.profile_align with backend='jax' on the CPU.

Tolerance: exact.  Scores are multiples of 1/16 plus float32 deletion
costs; both packages keep the same operation order, so score, qend, lane,
every code word that holds a step < qlen, and the walked CIGARs must be
equal bit for bit."""

import numpy as np
import pytest
import torch

from fslr_tpu.config import ScoringConfig
from fslr_tpu.ops import poa as jpoa
from fslr_tpu.ops import profile_align as jpa
from fslr_tpu_torch.ops import poa as tpoa
from fslr_tpu_torch.ops import profile_align as tpa
from tests.oracles import mutate, random_seq
from tests.test_torch_env import port_config

SC = ScoringConfig(gap_open_is_first_base=False)


def _graph(cls, rng, backbone):
    """A profile graph with uneven base counts and spans, so the planes
    hold fractional scores and per-column deletion costs."""
    gph = cls(backbone)
    L = len(backbone)
    extra = rng.integers(0, 4, (L, 4)).astype(np.int32)
    extra[rng.random(L) < 0.6] = 0
    gph.counts = gph.counts + extra
    gph.spans = gph.counts.sum(axis=1).astype(np.int32) + \
        rng.integers(0, 3, L).astype(np.int32)
    gph.counts[rng.random(L) < 0.02] = 0          # unsupported columns
    return gph


def _rows(seed: int, N: int, Lq: int):
    """(q, sp, g, qlens) from seeded reads against seeded profiles: reads
    are mutated copies of their profile's backbone, lengths not a
    multiple of 8, an N base, one all-pad row and one unrelated read."""
    rng = np.random.default_rng(seed)
    q = np.full((N, Lq), 4, np.uint8)
    sp = np.empty((N, Lq + 256), np.int32)
    g = np.empty((N, Lq + 256), np.float32)
    qlens = np.zeros(N, np.int32)
    for r in range(N):
        backbone = random_seq(rng, Lq + int(rng.integers(-40, 60)))
        gph = _graph(jpoa._ProfileGraph, rng, backbone)
        sp[r], g[r] = gph.planes(Lq, float(SC.match), float(SC.mismatch),
                                 float(SC.gap_extend))
        if r == 0:
            continue                                  # all-pad row
        read = (random_seq(rng, Lq) if r == 1 else
                mutate(rng, backbone, sub=0.06, indel=0.03))
        n = min(len(read), Lq - int(rng.integers(1, 8)))
        q[r, :n] = read[:n]
        qlens[r] = n
        if r == 2:
            q[r, n // 2] = 4                          # an N base
    return q, sp, g, qlens


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _live(bits, qlens):
    """Words holding a step < qlen (the kernel zeroes the rest)."""
    words = np.arange(bits.shape[1])[None, :]
    return words < ((qlens.astype(np.int64) + 7) // 8)[:, None]


CASES = [(0, 8, 256), (1, 8, 256), (2, 5, 128), (3, 6, 384)]


@pytest.mark.parametrize('seed,N,Lq', CASES)
def test_prof_matches_jax(seed, N, Lq):
    q, sp, g, qlens = _rows(seed, N, Lq)
    want = [np.asarray(x) for x in jpa.profile_banded_tb(
        q, sp, g, qlens, SC, backend='jax')]
    got = [x.numpy() for x in tpa.profile_banded_tb(
        *_t(q, sp, g, qlens), port_config(SC))]
    for name, a, b in zip(('score', 'qend', 'lane'), want[:3], got[:3]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    live = _live(got[3], qlens)
    np.testing.assert_array_equal(want[3][live], got[3][live])
    assert (got[0][1:] > 0).all() and got[0][0] == 0      # pad row: none
    assert (got[0] != np.round(got[0])).any()             # fractional


@pytest.mark.parametrize('seed,N,Lq', CASES)
def test_profile_align_walk_matches_jax(seed, N, Lq):
    q, sp, g, qlens = _rows(seed, N, Lq)
    want = jpa.profile_align_walk(q, sp, g, qlens, SC, backend='jax')
    got = tpa.profile_align_walk(*_t(q, sp, g, qlens), port_config(SC))
    for name, a, b in zip(('score', 'qend', 'lane', 'qstart', 'l_fin'),
                          want[:5], got[:5]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    assert got[5] == want[5]
    assert any(op in 'ID' for cig in got[5] for _, op in cig)


@pytest.mark.parametrize('seed', [0, 1])
def test_planes_equal_jax(seed):
    """The port's _ProfileGraph builds the same score and deletion-cost
    planes (fractional scores included)."""
    rng = np.random.default_rng(seed)
    backbone = random_seq(rng, 300)
    jg = _graph(jpoa._ProfileGraph, np.random.default_rng(seed), backbone)
    tg = _graph(tpoa._ProfileGraph, np.random.default_rng(seed), backbone)
    for Lq in (256, 384):
        for a, b in zip(jg.planes(Lq, 2.0, -3.0, 2.0),
                        tg.planes(Lq, 2.0, -3.0, 2.0)):
            np.testing.assert_array_equal(a, b)
    bytes_ = jg.planes(256, 2.0, -3.0, 2.0)[0].view(np.uint8)
    assert (bytes_.view(np.int8) % 16 != 0).any()           # fractional


def test_width_not_multiple_of_128_raises():
    q, sp, g, qlens = _rows(0, 2, 128)
    with pytest.raises(ValueError, match='multiple of 128'):
        tpa.profile_banded_tb(*_t(q[:, :120], sp[:, :376], g[:, :376],
                                  qlens), port_config(SC))
