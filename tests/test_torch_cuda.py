"""The CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips without a CUDA card.  On the card's
machine (no jax there, and tests/conftest.py imports it) run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

This file imports nothing of jax; chip_smoke.py checks the same kernels at
the main path's full shapes.
"""

import gzip
import os
import threading

import numpy as np
import pytest
import torch

import chip_smoke
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


SCORINGS = [ScoringConfig(), ScoringConfig(gap_open_is_first_base=False)]


@pytest.mark.parametrize('qmax', [72, 96, 128])
@pytest.mark.parametrize('sc', SCORINGS)
def test_sw_kernel_matches_plain(card, sc, qmax):
    """Queries up to 72, 96 and 128 bases (a warp runs 72 columns, or 128
    when one of its queries is longer)."""
    rng = np.random.default_rng(0)
    B, T = 300, 400
    q = rng.integers(0, 5, (B, 128)).astype(np.uint8)
    t = rng.integers(0, 5, (B, T)).astype(np.uint8)
    t[::3, 50:90] = q[::3, :40]
    qlens = rng.integers(0, qmax + 1, B).astype(np.int32)
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
    before = kernels.SW_PACKED.launches
    _assert_equal(ssw._sw_packed_cuda(*args, stride=stride, **kw),
                  ssw._sw_packed_torch(*args, stride=stride, **kw))
    assert kernels.SW_PACKED.launches == before + 1


@pytest.mark.parametrize('sc', SCORINGS)
@pytest.mark.parametrize('B', chip_smoke.SW_EDGE_ROWS)
def test_sw_kernels_edge_cases(card, B, sc):
    """Row counts that are not multiples of a warp's rows; qlen 0, 1, 68
    and 128; tlen 0, -1 and > T mixed in one warp, rows unsorted;
    all-mismatch and all-N rows; columns and rows tied at the maximum;
    code 4 in query and target; packed strides 32, 64 and 128 with a
    1-base primer, a full-stride one and one holding code 4.  Exact."""
    kw = ssw._scores(sc)
    args = _on(card, *chip_smoke.sw_edge_inputs(B))
    want = ssw._sw_torch(*args, **kw)
    if B > 3:
        assert float(want[0].max()) > 0 and float(want[0].min()) == 0
    _assert_equal(ssw._sw_cuda(*args, **kw), want)
    for stride in (32, 64, 128):
        args = _on(card, *chip_smoke.sw_packed_edge_inputs(B, stride))
        want = ssw._sw_packed_torch(*args, stride=stride, **kw)
        _assert_equal(ssw._sw_packed_cuda(*args, stride=stride, **kw), want)


@pytest.mark.parametrize('sc', SCORINGS)
@pytest.mark.parametrize('B', chip_smoke.SW_GRID_ROWS)
def test_sw_kernel_at_3072_on_grid_rows(card, B, sc):
    """sw_kernel at T = 3072 on rows shaped like the fused step's
    concatemer grid: primer-length queries, a third of the rows with
    tlen 0 and a third with a short tlen.  Exact."""
    kw = ssw._scores(sc)
    args = _on(card, *chip_smoke.sw_grid_inputs(B))
    want = ssw._sw_torch(*args, **kw)
    _assert_equal(ssw._sw_cuda(*args, **kw), want)
    if B > 5:
        assert float(want[0].max()) > 0
        assert not bool(want[0][args[3] == 0].any())


@pytest.mark.parametrize('packed', [False, True])
def test_sw_kernels_order_rows_by_descending_target_length(card, packed):
    """The C entry points fill the order scratch with a permutation of the
    rows by descending target length, clamped to T and to 4,095 (the
    counting sort's bins), before the DP; more rows than the sort's
    threads, and lengths past both clamps."""
    rng = np.random.default_rng(3)
    B, T = 3000, 5000
    q = rng.integers(0, 4, (B, 128)).astype(np.uint8)
    t = rng.integers(0, 4, (B, T)).astype(np.uint8)
    qlens = rng.integers(0, 129, B).astype(np.int32)
    tlens = rng.integers(-5, T + 100, B).astype(np.int32)
    q, t, qlens, tlens = _on(card, q, t, qlens, tlens)
    sc = ssw._sw_scores(**ssw._scores(ScoringConfig()))
    score, end, col, order = ssw._sw_outputs(B, card)
    if packed:
        kernels.SW_PACKED.launch(q, t, tlens, order, B, T, 32, *sc, score,
                                 end, col)
    else:
        kernels.SW.launch(q, t, qlens, tlens, order, B, T, *sc, score, end,
                          col)
    o = order.cpu().long()
    assert sorted(o.tolist()) == list(range(B))
    keys = tlens.cpu().long().clamp(0, min(T, 4095))[o]
    assert bool((keys[:-1] >= keys[1:]).all())


def test_sw_wrappers_refuse_fractional_scores_and_strides(card):
    q, t, qlens, tlens = _on(card, *chip_smoke.sw_edge_inputs(4))
    kw = dict(match=2.0, mismatch=-2.5, fg=5.0, ext=2.0)
    with pytest.raises(ValueError, match='not small integers'):
        ssw._sw_cuda(q, t, qlens, tlens, **kw)
    with pytest.raises(ValueError, match='not small integers'):
        ssw._sw_packed_cuda(q, t, tlens, stride=32, **kw)
    with pytest.raises(ValueError, match='first gap cost'):
        ssw._sw_cuda(q, t, qlens, tlens, match=2.0, mismatch=-3.0, fg=0.0,
                     ext=2.0)
    before = kernels.SW_PACKED.launches
    with pytest.raises(RuntimeError, match='sw_packed_kernel launch failed'):
        ssw._sw_packed_cuda(q, t, tlens, stride=24,
                            **ssw._scores(ScoringConfig()))
    assert kernels.SW_PACKED.launches == before


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


def _assert_mask_close(got, want, cfg):
    """Posteriors within 1e-4, and no decision differs."""
    assert float((got - want).abs().max()) < 1e-4
    thr = cfg.mask_posterior_threshold
    assert int(((got >= thr) != (want >= thr)).sum()) == 0


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
    before = kernels.MASK.launches
    got = tantan._posterior_cuda(st, cfg)
    assert kernels.MASK.launches == before + 1
    _assert_mask_close(got, tantan._posterior_torch(st, cfg), cfg)


def _mask_case(kind, rng):
    """Edge cases of the checkpointed mask kernel (B, L and content)."""
    if kind == 'ragged_batch':         # an odd B (one read per block)
        seq = rng.integers(0, 4, (5, 512))
        seq[2, 100:400] = np.tile(seq[2, 100:107], 43)[:300]
    elif kind in ('smallest_bucket', 'largest_bucket'):
        L = 512 if kind == 'smallest_bucket' else 32768
        seq = rng.integers(0, 4, (2, L))
        seq[0, 200:500] = np.tile(seq[0, 200:209], 34)[:300]
    elif kind == 'ragged_length':      # L not a multiple of the checkpoint
        seq = rng.integers(0, 4, (3, 1000))
        seq[1, 900:1000] = np.tile(seq[1, 900:904], 25)
    elif kind == 'homopolymer_and_n':  # the rescale's range guard
        seq = np.zeros((3, 3072), np.int64)
        seq[0, 3000:] = rng.integers(0, 4, 72)
        seq[1] = 4
        seq[2] = rng.integers(0, 4, 3072)
        seq[2, 1000:2500] = 2
    else:                              # period 1 and period 100 repeats
        seq = rng.integers(0, 4, (2, 1536))
        seq[0, 100:600] = 3
        unit = rng.integers(0, 4, 100)
        seq[1, 200:1200] = np.tile(unit, 10)
    return seq.astype(np.uint8)


@pytest.mark.parametrize('kind', ['ragged_batch', 'smallest_bucket',
                                  'largest_bucket', 'ragged_length',
                                  'homopolymer_and_n', 'periods_1_and_100'])
def test_mask_kernel_edge_cases(card, kind):
    seq = _mask_case(kind, np.random.default_rng(11))
    (st,) = _on(card, seq)
    cfg = JunkFilterConfig()
    got = tantan._posterior_cuda(st, cfg)
    want = tantan._posterior_torch(st, cfg)
    assert torch.isfinite(got).all()
    _assert_mask_close(got, want, cfg)
    if kind == 'periods_1_and_100':
        assert bool((want[0, 200:500] >= 0.5).all())
        assert bool((want[1, 700:1100] >= 0.5).any())


@pytest.mark.parametrize('what', ['length', 'period'])
def test_mask_wrapper_refuses_a_bucket_beyond_shared_memory(card, what):
    """The kernel keeps a read and one chunk of forward states in shared
    memory and 128 period slots a read: a longer bucket or a longer
    period raises at the launch, and the next launch still runs."""
    cfg = JunkFilterConfig()
    if what == 'length':
        seq = torch.zeros((1, 1 << 18), dtype=torch.uint8, device=card)
    else:
        seq = torch.zeros((1, 512), dtype=torch.uint8, device=card)
        cfg = JunkFilterConfig(mask_max_period=129)
    with pytest.raises(RuntimeError, match='mask_kernel launch failed'):
        tantan._posterior_cuda(seq, cfg)
    st = torch.zeros((2, 512), dtype=torch.uint8, device=card)
    assert tantan._posterior_cuda(st, JunkFilterConfig()).shape == (2, 512)


def test_mask_kernel_device_memory(card):
    """The only scratch is the checkpoints: one call at the filter's
    512 x 3072 batch allocates well under 64 MB."""
    st = torch.randint(0, 4, (512, 3072), dtype=torch.uint8, device=card)
    cfg = JunkFilterConfig()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    post = tantan._posterior_cuda(st, cfg)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= 64 << 20
    assert post.shape == (512, 3072)


def _band_edge_inputs(N, Lq=256, seed=12):
    """Rows 0..N-1 of a batch that mixes, unsorted: qlen 0, lengths 1..Lq,
    an all-mismatch row (score 0), mutated planted copies, and the
    tied-band-columns witness (two equal 40 bp matches on lanes 24
    apart, ROADMAP section 3)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, Lq)).astype(np.uint8)
    w = rng.integers(0, 5, (N, Lq + 256)).astype(np.uint8)
    qlens = rng.integers(1, Lq + 1, N).astype(np.int32)
    for r in range(N):
        kind = r % 5
        if kind == 0:
            qlens[r] = 0
        elif kind == 1:                           # every cell mismatches
            q[r] = 0
            w[r] = rng.integers(1, 4, Lq + 256)
        elif kind == 2:
            off = int(rng.integers(0, 100))
            seg = q[r, :Lq // 2].copy()
            seg[rng.random(len(seg)) < 0.05] = 2
            seg = np.delete(seg, [10, 60])
            w[r, off:off + len(seg)] = seg
        elif kind == 3:                           # tied columns
            x = rng.integers(0, 4, 40).astype(np.uint8)
            q[r, :40] = x
            q[r, 100:140] = x
            w[r, 10:50] = x
            w[r, 134:174] = x
            qlens[r] = max(int(qlens[r]), 150)
    return q, w, qlens


@pytest.mark.parametrize('wide', [False, True])
@pytest.mark.parametrize('N', range(1, 10))
def test_banded_and_tb_edge_cases(card, N, wide):
    q, w, qlens = _band_edge_inputs(9)
    args = _on(card, q[:N], w[:N], qlens[:N])
    kw = ssw._scores(ScoringConfig(gap_open_is_first_base=False))
    got = banded._banded_cuda(*args, cpl=banded.LAYOUTS[wide], **kw)
    _assert_equal(got, banded._banded_torch(*args, **kw))
    got = traceback._tb_cuda(*args, cpl=traceback.LAYOUTS[wide], **kw)
    want = traceback._tb_torch(*args, **kw)
    _assert_equal(got[:3], want[:3])
    _assert_bits_equal(got[3], want[3], args[2])
    assert float(want[0][0]) == 0.0
    if N > 3:
        assert float(want[0][1]) == 0.0 and float(want[0][3]) >= 80.0


@pytest.mark.parametrize('wide', [False, True])
def test_banded_and_tb_layouts_match_plain(card, wide):
    """Each layout at a wider launch: many warps, ragged qlens."""
    args = _on(card, *_tb_inputs(13, N=300, Lq=512))
    kw = ssw._scores(ScoringConfig())
    _assert_equal(banded._banded_cuda(*args, cpl=banded.LAYOUTS[wide], **kw),
                  banded._banded_torch(*args, **kw))
    got = traceback._tb_cuda(*args, cpl=traceback.LAYOUTS[wide], **kw)
    want = traceback._tb_torch(*args, **kw)
    _assert_equal(got[:3], want[:3])
    _assert_bits_equal(got[3], want[3], args[2])


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


@pytest.mark.parametrize('Lq', chip_smoke.PROF_EDGE_WIDTHS)
@pytest.mark.parametrize('N', chip_smoke.PROF_EDGE_ROWS)
def test_prof_kernel_edge_cases(card, N, Lq):
    """1, 3, 5 and 33 rows (one row a warp) at widths 128 and 3,072: qlen
    0, qlen = Lq, qlen not a multiple of 8, read bases 4, an all-pad row,
    tied band columns, a 5-base read, unsupported profile columns.
    Exact in the ends and the live code words; zeros after."""
    args = _on(card, *chip_smoke.prof_edge_inputs(N, Lq))
    kw = profile_align._scores(ScoringConfig(gap_open_is_first_base=False))
    before = kernels.PROF.launches
    got = profile_align._prof_cuda(*args, **kw)
    assert kernels.PROF.launches == before + 1
    want = profile_align._prof_torch(*args, **kw)
    chip_smoke._check_codes('prof_kernel', got, want, args[3])
    assert float(want[0][0]) == 0.0
    if N > 3:
        assert int(args[3][1]) == Lq and float(want[0][1]) > 0


@pytest.mark.parametrize('N,Lq', [(1, 256), (6, 256), (4097, 64)])
def test_walk_kernel_edge_cases(card, N, Lq):
    """Score-0 rows, all-diagonal paths down to i = 0 (runs far longer
    than 8), I runs across word rows clamped at lane 127, D runs clamped
    at lane 0, random paths; 1 row, and more than 4,096.  Exact."""
    bits, score, qend, lane = _on(card, *chip_smoke.walk_edge_inputs(N, Lq))
    before = kernels.WALK.launches
    got = traceback._walk_cuda(bits, score, qend, lane)
    assert kernels.WALK.launches == before + 1
    want = traceback._pack_walk(score, qend, lane, *traceback._walk_torch(
        bits, qend, lane, Lq + 128))
    _assert_equal(got, want)


@pytest.mark.parametrize('source', ['tb', 'prof'])
def test_walk_kernel_on_the_kernels_codes(card, source):
    """The walk on the codes tb_kernel and prof_kernel wrote on the card
    (their words past a row's end are zeros), against the plain walk of
    the same codes."""
    if source == 'tb':
        args = _on(card, *_tb_inputs(7, N=300, Lq=512))
        score, qend, lane, bits = traceback._tb_cuda(
            *args, **ssw._scores(ScoringConfig()))
    else:
        args = _on(card, *_prof_inputs(40, 384, seed=9))
        score, qend, lane, bits = profile_align._prof_cuda(
            *args, **profile_align._scores(
                ScoringConfig(gap_open_is_first_base=False)))
    T = bits.shape[1] * 8 + 128
    want = traceback._pack_walk(score, qend, lane, *traceback._walk_torch(
        bits, qend, lane, T))
    _assert_equal(traceback._walk_cuda(bits, score, qend, lane), want)


def test_profile_align_walk_card_equals_cpu(card):
    arrays = _prof_inputs(12, 384, seed=8)
    sc = ScoringConfig(gap_open_is_first_base=False)
    before = kernels.WALK.launches
    got = profile_align.profile_align_walk(*_on(card, *arrays[:3]),
                                           arrays[3], sc)
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


@pytest.mark.parametrize('cap', [10 ** 9, 9000, 5000], ids=['1', '2', '3'])
def test_device_build_equals_cpu_build(card, cap):
    """The seed index built on the card equals the CPU build and this
    repo's numpy checker (chip_smoke.numpy_index), with N bases, contig
    boundaries and contigs shorter than k, in 1, 2 and 3 shards."""
    from fslr_tpu_torch.index.reference import Reference, build_seed_index
    rng = np.random.default_rng(5)
    parts = [rng.integers(0, 5, n).astype(np.uint8)
             for n in (4000, 3, 4500, 10, 4000)]
    lengths = np.array([len(p) for p in parts], np.int64)
    ref = Reference(names=[f'c{i}' for i in range(len(parts))],
                    lengths=lengths,
                    offsets=np.concatenate([[0], np.cumsum(lengths)]),
                    codes=np.concatenate(parts))
    got = build_seed_index(ref, 11, card, cap)
    want = build_seed_index(ref, 11, torch.device('cpu'), cap)
    shards = chip_smoke._shards(ref, got)
    assert len(shards) == {10 ** 9: 1, 9000: 2, 5000: 3}[cap]
    for (sref, a, base), (_, b, base_b) in zip(shards,
                                               chip_smoke._shards(ref, want)):
        assert base == base_b
        counts, positions = chip_smoke.numpy_index(sref.codes, sref.offsets,
                                                   11)
        for x in (a, b):
            np.testing.assert_array_equal(x.counts, counts)
            np.testing.assert_array_equal(x.positions, positions)


def test_sharded_align_batch_card_equals_cpu(card, tmp_path):
    """align_batch with a 2-shard index: card == CPU, every column and
    CIGAR, and equal to the unsharded index's alignments."""
    from fslr_tpu_torch.index.reference import build_seed_index, \
        load_reference
    from fslr_tpu_torch.io.fastq import read_reads
    ref_path, fq = make_dataset(str(tmp_path), 40, 4)
    ref = load_reference(ref_path)
    codes = read_reads(os.path.join(fq, 'b0.fastq'))
    codes = codes.codes_slice(0, codes.n)
    rows = [chip_smoke._align_rows(
        ref, build_seed_index(ref, 11, dev, cap), dev, codes)
        for dev, cap in ((card, 3_000_000), (torch.device('cpu'), 3_000_000),
                         (card, 10 ** 9))]
    assert rows[0] == rows[1] == rows[2]
    assert len(rows[0]) >= 40


def test_masked_slice_card_equals_cpu(card, tmp_path):
    """run_pipeline with reference_mask on the card and on the CPU."""
    from fslr_tpu_torch.pipeline import run_pipeline
    ref, fq = make_dataset(str(tmp_path), 30, 3)
    mask = tmp_path / 'mask.bed'
    mask.write_text(chip_smoke.CROSS_MASK)
    bases = []
    for dev in (card, torch.device('cpu')):
        out = str(tmp_path / dev.type)
        run_pipeline(PipelineConfig(name='D', out=out, ref=ref,
                                    primers=('21q1', '17p6'), basecalled=fq,
                                    skip_clustering=True,
                                    reference_mask=str(mask)), dev)
        bases.append(os.path.join(out, 'D'))
        assert not [n for n in os.listdir(out) if '_temp_ref' in n]
    for suffix in ('.mappings.bed', '.filter_counts_summary.csv'):
        with open(bases[0] + suffix, 'rb') as a, \
                open(bases[1] + suffix, 'rb') as b:
            assert a.read() == b.read(), suffix
    with open(bases[0] + '.bwa_dodi.bam', 'rb') as a, \
            open(bases[1] + '.bwa_dodi.bam', 'rb') as b:
        assert gzip.decompress(a.read()) == gzip.decompress(b.read())


def _interval_soup(seed, n_reads=300):
    """Interval items (sorted by start, as prepare_data gives them) of
    reads with 1-3 interior intervals around four breakpoints on two
    chromosomes, two reads whose qlen2 ratio is exactly 1 - qlen_diff
    (2400 / 2500; their n_alignments ratio 3/5 fails), and one read of 35
    intervals (past the Jaccard table's 32: the exact host mirror)."""
    from fslr_tpu_torch.stages.cluster import IntervalItem
    rng = np.random.default_rng(seed)
    bps = [(1, 2_000_000), (1, 2_000_600), (2, 4_000_000), (1, 7_000_000)]
    reads = []
    for r in range(n_reads):
        segs = []
        for _ in range(int(rng.integers(1, 4))):
            c, s = bps[int(rng.integers(0, len(bps)))]
            s += int(rng.integers(-60, 61))
            segs.append((c, s, s + 1000 + int(rng.integers(-80, 81))))
        reads.append((f'R{r}', segs))
    reads.append(('BL0', [(1, 5_000_000, 5_002_400)]))
    reads.append(('BL1', [(1, 5_000_000, 5_000_800), (1, 5_000_700, 5_001_500),
                          (1, 5_001_400, 5_002_300)]))
    reads.append(('BIG', [(1, 2_000_000 + 20 * k, 2_001_000 + 20 * k)
                          for k in range(35)]))
    items = []
    for name, segs in reads:
        qlen2 = {'BL0': 2400, 'BL1': 2500}.get(
            name, sum(e - s for _, s, e in segs))
        for c, s, e in segs:
            items.append(IntervalItem(c, s, e, float(e - s), name,
                                      len(segs) + 2, qlen2,
                                      (e - s) // 2 + s, len(items)))
    items.sort(key=lambda it: it.start)
    return items


def _graph(data, dev, **kw):
    from fslr_tpu_torch.config import ClusterConfig
    from fslr_tpu_torch.stages.cluster import query_graph
    cfg = ClusterConfig(device_enum_min_encounters=0, **kw)
    stats = {}
    m, e, n = query_graph(data, cfg.overlap, list(cfg.jaccard_cutoffs),
                          cfg.edge_threshold, cfg.qlen_diff,
                          cfg.n_alignment_diff, cfg, dev, stats)
    return (m, e, list(n.items())), stats['path']


@pytest.mark.parametrize('case', ['soup', 'soup_capped_small_slices',
                                  'cluster_scale'])
def test_scale_path_card_equals_cpu(card, case, monkeypatch):
    """The scale path of clustering (ops/encounters.py, capwalk.
    resolve_device) on the card, in-HBM, sharded and spilled, equals its
    CPU run: edges in order, node order, match rows."""
    from fslr_tpu_torch.ops import encounters
    from fslr_tpu_torch.tools.synth import make_cluster_scale_data
    kw = {}
    if case == 'cluster_scale':
        data = make_cluster_scale_data(5_000)     # 7 groups of 700
    else:
        data = _interval_soup(3)
        if case == 'soup_capped_small_slices':
            kw = dict(edge_threshold=3, enum_slice_cap=4096,
                      enum_merge_cap=8192)
    want, path = _graph(data, torch.device('cpu'), **kw)
    assert path == 'in-HBM' and len(want[1]) > 100
    assert _graph(data, card, **kw) == (want, 'in-HBM')
    assert _graph(data, card, enum_spill_min_encounters=1, **kw) == \
        (want, 'sharded')
    monkeypatch.setattr(encounters, 'SPILL_DIRECT_MIN', 0)
    assert _graph(data, card, **kw) == (want, 'spill')


def _sw_rows(n, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (n, 128)).astype(np.uint8)
    t = rng.integers(0, 4, (n, 400)).astype(np.uint8)
    t[:, 100:160] = q[:, :60]
    return (q, t, rng.integers(20, 129, n).astype(np.int32),
            rng.integers(100, 401, n).astype(np.int32))


def test_launch_runs_on_the_current_device(card):
    """A kernel launched from a thread that never chose a device, on
    tensors of torch.cuda.current_device(): it runs there (equal to the
    plain version) and counts once."""
    dev = torch.device('cuda', torch.cuda.current_device())
    q, t, qlens, tlens = (torch.from_numpy(a) for a in _sw_rows(64))
    want = ssw.sw_max(q, t, qlens, tlens, ScoringConfig())
    box = {}

    def run():
        kernels.reset_launches()
        box['got'] = ssw.sw_max(*(x.to(dev) for x in (q, t, qlens, tlens)),
                                ScoringConfig())
        torch.cuda.synchronize(dev)
        box['launches'] = kernels.launch_counts()['sw_kernel']

    th = threading.Thread(target=run)
    th.start()
    th.join()
    _assert_equal(box['got'], want)
    assert box['launches'] == 1


def test_dp_call_shards_enter_their_device(card):
    """dp_call on a mesh of two entries on the card: each shard runs on
    the calling thread with the card current, and the outputs equal the
    plain call's (9 rows: padding to 10)."""
    from fslr_tpu_torch.parallel import dispatch
    from fslr_tpu_torch.parallel.mesh import Mesh
    dev = torch.device('cuda', torch.cuda.current_device())
    args = [torch.from_numpy(a).to(dev) for a in _sw_rows(9)]
    seen = []

    def fn(q, t, qlens, tlens, sc):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_device(), q.device))
        return ssw.sw_locate(q, t, qlens, tlens, sc)

    want = ssw.sw_locate(*args, ScoringConfig())
    with dispatch.use_mesh(Mesh((dev, dev))):
        got = dispatch.dp_call(fn, args, statics=(ScoringConfig(),))
    for k in want:
        assert torch.equal(got[k].cpu(), want[k].cpu()), k
    assert len(seen) == 2
    assert all(n == threading.current_thread().name and i == dev.index
               and d == dev for n, i, d in seen)


@pytest.mark.parametrize('consensus', [False, True], ids=['slice', 'consensus'])
def test_mesh_of_two_equals_one_device(card, tmp_path, consensus):
    """run_pipeline (exact CIGARs) on a mesh of two entries on the card
    gives the artifacts of the one-device run, BAM included."""
    from fslr_tpu_torch.parallel.mesh import Mesh
    from fslr_tpu_torch.pipeline import run_pipeline
    ref, fq = make_dataset(str(tmp_path), 60, 3)
    dev = torch.device('cuda', torch.cuda.current_device())
    bases = []
    for tag, mesh in (('one', None), ('mesh', Mesh((dev, dev)))):
        out = str(tmp_path / tag)
        run_pipeline(PipelineConfig(name='D', out=out, ref=ref,
                                    primers=('21q1', '17p6'), basecalled=fq,
                                    skip_clustering=not consensus,
                                    run_consensus=consensus), card,
                     mesh=mesh)
        bases.append(os.path.join(out, 'D'))
    suffixes = ['.mappings.bed', '.filter_counts_summary.csv',
                '.without_primers.fq', '.bwa_dodi.bam', '.bwa_dodi.bam.bai']
    if consensus:
        suffixes += ['.mappings.cluster.bed', '.mappings.representative.bed',
                     '.mappings_merged.bed', '.bwa_dodi_merged.bam']
    for suffix in suffixes:
        with open(bases[0] + suffix, 'rb') as a, \
                open(bases[1] + suffix, 'rb') as b:
            assert a.read() == b.read(), suffix


def test_fused_step_card_equals_plain(card, tmp_path):
    """parallel.step on 64 synthetic amplicons at L = 3072 with the whole
    panel: only mask_kernel, sw_kernel, tb_kernel and walk_kernel launch,
    the outputs equal the plain versions' on the card (a junk flag may
    differ only where a mask decision does), and the mesh (card, card)
    equals one device."""
    from fslr_tpu_torch.io.fastq import read_fastx
    from fslr_tpu_torch.parallel.mesh import Mesh
    from fslr_tpu_torch.parallel.step import (make_device_step,
                                              make_sharded_step)
    from fslr_tpu_torch.tools.synth import step_inputs
    ref, fq = make_dataset(str(tmp_path), 64, 4)
    seqs = [r.sequence for r in read_fastx(os.path.join(fq, 'b0.fastq'))]
    seqs[3] = seqs[3][:150]                       # a short read
    seqs[5] = seqs[5][:300] + 'AT' * 200 + seqs[5][300:]   # a junk read
    L = chip_smoke.STEP_L
    args = step_inputs(ref, seqs, L, card)
    config = PipelineConfig()
    n_seed = (L - config.align.seed_k) // config.align.seed_stride + 1
    step = make_device_step(config, args[2].shape[0], L, n_seed)
    kernels.reset_launches()
    got = step(*args)
    launches = kernels.launch_counts()
    assert {k for k, v in launches.items() if v} == set(chip_smoke.STEP_PATH)
    assert got['short'][3] and got['junk'][5]
    want = chip_smoke._plain(lambda: step(*args))
    post_k = tantan._posterior_cuda(args[0], config.junk)
    post_p = tantan._posterior_torch(args[0], config.junk)
    thr = config.junk.mask_posterior_threshold
    differ = (post_k >= thr) != (post_p >= thr)
    chip_smoke._same_step(got, want, 'card against plain',
                          torch.nonzero(differ.any(1)).flatten().tolist())
    mesh = Mesh((card, card))
    chip_smoke._same_step(make_sharded_step(mesh, config, args[2].shape[0],
                                            L, n_seed)(*args), got,
                          'mesh against one device')


# ---------------------------------------------------------------------------
# Several cards (each test skips below two; chip_smoke.py --cards N runs
# the whole multi-card path)
# ---------------------------------------------------------------------------

@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip('needs at least two CUDA cards')
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def test_dp_call_over_every_card_equals_plain(cards):
    """dp_call on a mesh of every card: each card launches sw_kernel on
    its shard (11 rows: padding to a multiple of the cards), and the
    gathered outputs, on the first card, equal the plain call's."""
    from fslr_tpu_torch.parallel import dispatch
    from fslr_tpu_torch.parallel.mesh import Mesh
    args = [torch.from_numpy(a).to(cards[0]) for a in _sw_rows(11)]
    want = ssw.sw_locate(*args, ScoringConfig())
    kernels.reset_launches()
    with dispatch.use_mesh(Mesh(tuple(cards))):
        got = dispatch.dp_call(ssw.sw_locate, args,
                               statics=(ScoringConfig(),))
    by_card = kernels.launch_counts(by_device=True)['sw_kernel']
    assert set(by_card) == {d.index for d in cards}
    for k in want:
        assert got[k].device == cards[0]
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


def test_replicas_place_one_copy_a_card(cards):
    """dispatch.replicas: the table itself on its card, one copy on each
    other card, made once while the table lives."""
    from fslr_tpu_torch.parallel import dispatch
    from fslr_tpu_torch.parallel.mesh import Mesh
    table = torch.arange(100_003, dtype=torch.int32, device=cards[0])
    with dispatch.use_mesh(Mesh(tuple(cards))):
        reps = dispatch.replicas(table)
        again = dispatch.replicas(table)
    assert reps[0] is table
    assert [r.device for r in reps] == cards
    assert all(a is b for a, b in zip(reps, again))
    assert all(torch.equal(r.cpu(), table.cpu()) for r in reps)


@pytest.mark.parametrize('consensus', [False, True], ids=['slice', 'consensus'])
def test_mesh_of_every_card_equals_one_card(cards, tmp_path, consensus):
    """run_pipeline (exact CIGARs) on a mesh of every card gives the
    artifacts of the one-card run, BAM and index included; every card
    launches the slice's kernels (and with consensus, prof_kernel)."""
    from fslr_tpu_torch.parallel.mesh import Mesh
    from fslr_tpu_torch.pipeline import run_pipeline
    ref, fq = make_dataset(str(tmp_path), 60, 3)
    bases = []
    for tag, mesh in (('one', None), ('mesh', Mesh(tuple(cards)))):
        out = str(tmp_path / tag)
        kernels.reset_launches()
        run_pipeline(PipelineConfig(name='D', out=out, ref=ref,
                                    primers=('21q1', '17p6'), basecalled=fq,
                                    skip_clustering=not consensus,
                                    run_consensus=consensus), cards[0],
                     mesh=mesh)
        bases.append(os.path.join(out, 'D'))
    by_card = kernels.launch_counts(by_device=True)
    want = chip_smoke.SLICE_PATH + (('prof_kernel',) if consensus else ())
    for name in want:
        assert set(by_card[name]) == {d.index for d in cards}, name
    suffixes = ['.mappings.bed', '.filter_counts_summary.csv',
                '.without_primers.fq', '.bwa_dodi.bam', '.bwa_dodi.bam.bai']
    if consensus:
        suffixes += ['.mappings.cluster.bed', '.mappings.representative.bed',
                     '.mappings_merged.bed', '.bwa_dodi_merged.bam']
    for suffix in suffixes:
        with open(bases[0] + suffix, 'rb') as a, \
                open(bases[1] + suffix, 'rb') as b:
            assert a.read() == b.read(), suffix
