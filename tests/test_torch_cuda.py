"""The CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips without a CUDA card.  On the card's
machine (no jax there, and tests/conftest.py imports it) run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

This file imports nothing of jax; chip_smoke.py checks the same kernels at
the main path's full shapes.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from fslr_tpu_torch import kernels
from fslr_tpu_torch.config import (JunkFilterConfig, PipelineConfig,
                                   ScoringConfig)
from fslr_tpu_torch.ops import (banded, poa, profile_align, ssw, tantan,
                                traceback)
from fslr_tpu_torch.tools.synth import make_dataset

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize('sc', [ScoringConfig(),
                                ScoringConfig(gap_open_is_first_base=False)])
def test_sw_kernel_matches_plain(card, sc):
    rng = np.random.default_rng(0)
    B, T = 300, 400
    q = rng.integers(0, 5, (B, 128)).astype(np.uint8)
    t = rng.integers(0, 5, (B, T)).astype(np.uint8)
    t[::3, 50:90] = q[::3, :40]
    qlens = rng.integers(0, 129, B).astype(np.int32)
    tlens = rng.integers(0, T + 1, B).astype(np.int32)
    args = _on(card, q, t, qlens, tlens)
    kw = ssw._scores(sc)
    before = kernels.SW.launches
    _assert_equal(ssw._sw_cuda(*args, **kw), ssw._sw_torch(*args, **kw))
    assert kernels.SW.launches == before + 1


@pytest.mark.parametrize('stride', [32, 64])
def test_sw_packed_kernel_matches_plain(card, stride):
    rng = np.random.default_rng(1)
    B, T = 200, 700
    codes = [rng.integers(0, 4, 20).astype(np.uint8) for _ in range(4)]
    rows, _, _ = ssw.pack_queries(codes, stride)
    q = rows[np.arange(B) % len(rows)]
    t = rng.integers(0, 5, (B, T)).astype(np.uint8)
    t[::2, 100:120] = codes[0]
    tlens = rng.integers(0, T + 1, B).astype(np.int32)
    args = _on(card, q, t, tlens)
    kw = ssw._scores(ScoringConfig())
    _assert_equal(ssw._sw_packed_cuda(*args, stride=stride, **kw),
                  ssw._sw_packed_torch(*args, stride=stride, **kw))


def test_banded_kernel_matches_plain(card):
    rng = np.random.default_rng(2)
    N, Lq = 200, 384
    q = rng.integers(0, 5, (N, Lq)).astype(np.uint8)
    w = rng.integers(0, 5, (N, Lq + 256)).astype(np.uint8)
    w[::2, 70:70 + 300] = q[::2, :300]
    qlens = rng.integers(0, Lq + 1, N).astype(np.int32)
    args = _on(card, q, w, qlens)
    kw = ssw._scores(ScoringConfig(gap_open_is_first_base=False))
    _assert_equal(banded._banded_cuda(*args, **kw),
                  banded._banded_torch(*args, **kw))


def _tb_inputs(seed, N=200, Lq=384):
    """Mutated copies planted in the windows; qlens not multiples of 8,
    row 0 scores nothing."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (N, Lq)).astype(np.uint8)
    w = rng.integers(0, 5, (N, Lq + 256)).astype(np.uint8)
    for r in range(1, N, 2):
        off = int(rng.integers(0, 120))
        seg = q[r, :300].copy()
        seg[rng.random(300) < 0.05] = 1
        seg = np.delete(seg, rng.integers(0, 300, 4))
        w[r, off:off + len(seg)] = seg
    qlens = rng.integers(0, Lq + 1, N).astype(np.int32)
    qlens[1:6] = (13, 77, 8, 1, Lq - 3)
    q[0] = 4
    return q, w, qlens


def _assert_bits_equal(got, want, qlens):
    """Words holding steps < qlens equal the plain version's; the kernel
    zeroes the words after them."""
    words = (qlens.cpu().long() + 7) // 8
    live = torch.arange(got.shape[1])[None, :] < words[:, None]
    got, want = got.cpu(), want.cpu()
    assert torch.equal(got[live], want[live])
    assert not got[~live].any()


def test_tb_kernel_matches_plain(card):
    args = _on(card, *_tb_inputs(4))
    kw = ssw._scores(ScoringConfig(gap_open_is_first_base=False))
    before = kernels.TB.launches
    got = traceback._tb_cuda(*args, **kw)
    want = traceback._tb_torch(*args, **kw)
    assert kernels.TB.launches == before + 1
    _assert_equal(got[:3], want[:3])
    assert float(want[0][0]) == 0.0
    _assert_bits_equal(got[3], want[3], args[2])


def test_walk_kernel_matches_plain(card):
    args = _on(card, *_tb_inputs(5))
    score, qend, lane, bits = traceback._tb_torch(
        *args, **ssw._scores(ScoringConfig(gap_open_is_first_base=False)))
    before = kernels.WALK.launches
    got = traceback._walk_cuda(bits, score, qend, lane)
    assert kernels.WALK.launches == before + 1
    T = bits.shape[1] * 8 + 128
    want = traceback._pack_walk(score, qend, lane,
                                *traceback._walk_torch(bits, qend, lane, T))
    _assert_equal(got, want)


def test_mask_kernel_matches_plain(card):
    rng = np.random.default_rng(3)
    B, L = 64, 1024
    seq = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for r in range(0, B, 2):
        p = int(rng.integers(1, 60))
        seq[r, 300:700] = np.tile(seq[r, 300:300 + p], 400 // p + 1)[:400]
    seq[1::5, 500:520] = 4
    (st,) = _on(card, seq)
    cfg = JunkFilterConfig()
    got = tantan._posterior_cuda(st, cfg)
    want = tantan._posterior_torch(st, cfg)
    assert float((got - want).abs().max()) < 1e-4
    thr = cfg.mask_posterior_threshold
    assert int(((got >= thr) != (want >= thr)).sum()) == 0


def _prof_inputs(N, Lq, seed=6):
    """Reads against POA profiles with fractional scores (substitution
    and insertion updates through _ProfileGraph), row 0 all pad."""
    rng = np.random.default_rng(seed)
    q = np.full((N, Lq), 4, np.uint8)
    sp = np.empty((N, Lq + 256), np.int32)
    g = np.empty((N, Lq + 256), np.float32)
    qlens = np.zeros(N, np.int32)
    for r in range(N):
        L = Lq - int(rng.integers(1, 100))
        backbone = rng.integers(0, 4, L).astype(np.uint8)
        gph = poa._ProfileGraph(backbone)
        for _ in range(3):
            read = backbone.copy()
            sub = rng.random(L) < 0.08
            read[sub] = rng.integers(0, 4, int(sub.sum()))
            gph.update(read, 0, 0, [(L, 'M')])
        gph.update(np.concatenate([backbone[:L // 2], backbone[:4],
                                   backbone[L // 2:]]), 0, 0,
                   [(L // 2, 'M'), (4, 'I'), (L - L // 2, 'M')])
        sp[r], g[r] = gph.planes(Lq, 2.0, -3.0, 2.0)
        if r:
            n = L - int(rng.integers(0, 30))
            read = backbone[:n].copy()
            read[rng.random(n) < 0.05] = 3
            q[r, :n] = read
            qlens[r] = n
    return q, sp, g, qlens


def test_prof_kernel_matches_plain(card):
    args = _on(card, *_prof_inputs(24, 512))
    kw = profile_align._scores(ScoringConfig(gap_open_is_first_base=False))
    before = kernels.PROF.launches
    got = profile_align._prof_cuda(*args, **kw)
    want = profile_align._prof_torch(*args, **kw)
    assert kernels.PROF.launches == before + 1
    _assert_equal(got[:3], want[:3])
    assert float(got[0][0]) == 0.0 and bool((got[0][1:] > 0).all())
    _assert_bits_equal(got[3], want[3], args[3])


def test_profile_align_walk_card_equals_cpu(card):
    arrays = _prof_inputs(12, 384, seed=8)
    sc = ScoringConfig(gap_open_is_first_base=False)
    before = kernels.WALK.launches
    got = profile_align.profile_align_walk(*_on(card, *arrays), sc)
    want = profile_align.profile_align_walk(
        *_on(torch.device('cpu'), *arrays), sc)
    assert kernels.WALK.launches == before + 1
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got[5] == want[5]


def test_kernel_wrapper_rejects_bad_arguments(card):
    q, t, qlens, tlens = _on(card, np.zeros((4, 128), np.uint8),
                             np.zeros((4, 64), np.uint8),
                             np.zeros(4, np.int32), np.zeros(4, np.int64))
    with pytest.raises(ValueError, match='tlens'):
        ssw._sw_cuda(q, t, qlens, tlens, **ssw._scores(ScoringConfig()))


@pytest.mark.parametrize('exact,consensus', [(False, False), (True, False),
                                             (True, True)])
def test_slice_card_equals_cpu(card, tmp_path, exact, consensus):
    from fslr_tpu_torch.pipeline import run_pipeline
    ref, fq = make_dataset(str(tmp_path), 30, 3)
    bases = []
    for dev in (card, torch.device('cpu')):
        out = str(tmp_path / dev.type)
        run_pipeline(PipelineConfig(name='D', out=out, ref=ref,
                                    primers=('21q1', '17p6'), basecalled=fq,
                                    skip_clustering=not consensus,
                                    run_consensus=consensus,
                                    exact_cigars=exact), dev)
        bases.append(os.path.join(out, 'D'))
    suffixes = ['.mappings.bed', '.filter_counts_summary.csv']
    if consensus:
        suffixes += ['.mappings.cluster.bed', '.mappings.representative.bed',
                     '.mappings_merged.bed']
    for suffix in suffixes:
        with open(bases[0] + suffix, 'rb') as a, \
                open(bases[1] + suffix, 'rb') as b:
            assert a.read() == b.read(), suffix
    for bam in ['.bwa_dodi.bam'] + (['.bwa_dodi_merged.bam'] if consensus
                                    else []):
        with open(bases[0] + bam, 'rb') as a, \
                open(bases[1] + bam, 'rb') as b:
            assert gzip.decompress(a.read()) == gzip.decompress(b.read())
