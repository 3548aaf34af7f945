"""fslr_tpu_torch align ops against fslr_tpu on the CPU: banded SW, the
forward + reverse score extension, seeding, selection, the device index
and align_batch itself.  All integer or integer-valued float32 results, so
every comparison is exact."""

import dataclasses

import numpy as np
import pytest
import torch

from fslr_tpu.config import AlignConfig, PipelineConfig, ScoringConfig
from fslr_tpu.encode import decode, encode_cat, revcomp_str
from fslr_tpu.index.reference import Reference, SeedIndex, build_seed_index
from fslr_tpu.ops import banded as jband
from fslr_tpu.ops import seed as jseed
from fslr_tpu.ops import selection as jsel
from fslr_tpu.stages import align as jalign
from fslr_tpu_torch.ops import banded as tband
from fslr_tpu_torch.ops import seed as tseed
from fslr_tpu_torch.ops import selection as tsel
from fslr_tpu_torch.stages import align as talign
from tests.test_torch_env import port_config
from tests.oracles import mutate, random_seq

BWA_SC = ScoringConfig(gap_open_is_first_base=False)
CONFIG = PipelineConfig(exact_cigars=False)
TCONFIG = port_config(CONFIG)
CPU = torch.device('cpu')


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _mk_ref(rng, sizes, repeat=None):
    """Random contigs; ``repeat=(length, copies)`` plants copies of one
    segment so that k-mers exceed the occurrence cap."""
    parts = [random_seq(rng, s) for s in sizes]
    if repeat:
        seg = random_seq(rng, repeat[0])
        for c in range(repeat[1]):
            p = 1000 + c * (repeat[0] + 37)
            parts[0][p:p + repeat[0]] = mutate(rng, seg, sub=0.01,
                                               indel=0.0)[:repeat[0]]
    lengths = np.array([len(p) for p in parts], np.int64)
    return Reference(names=[f'chr{i + 1}' for i in range(len(parts))],
                     lengths=lengths,
                     offsets=np.concatenate([[0], np.cumsum(lengths)]),
                     codes=np.concatenate(parts))


@pytest.fixture(scope='module')
def ref_and_index():
    ref = _mk_ref(np.random.default_rng(42), [20000, 20000])
    return ref, build_seed_index(ref, k=11)


@pytest.fixture(scope='module')
def repetitive_ref():
    ref = _mk_ref(np.random.default_rng(9), [30000, 5000],
                  repeat=(400, 30))
    return ref, build_seed_index(ref, k=11)


def _banded_rows(seed, N=6, Lq=256):
    rng = np.random.default_rng(seed)
    q = np.full((N, Lq), 4, np.uint8)
    w = np.full((N, Lq + 256), 4, np.uint8)
    qlens = np.zeros(N, np.int32)
    for r in range(N):
        read = random_seq(rng, int(rng.integers(20, Lq)), 0.02)
        seg = mutate(rng, read, sub=0.05, indel=0.03)
        win = np.concatenate([random_seq(rng, int(rng.integers(0, 120))),
                              seg, random_seq(rng, Lq + 256)])
        q[r, :len(read)] = read
        qlens[r] = len(read) if r != 3 else 0
        w[r] = win[:Lq + 256]
    return q, w, qlens


@pytest.mark.parametrize('backend', ['jax', 'pallas_interpret'])
def test_banded_sw_matches(backend):
    q, w, qlens = _banded_rows(0, N=4)
    want = jband.banded_sw(q, w, qlens, BWA_SC, backend=backend)
    got = tband.banded_sw(*_t(q, w, qlens), port_config(BWA_SC))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize('sc', [BWA_SC, ScoringConfig()], ids=['bwa', 'ssw'])
def test_banded_extend_score_matches(sc):
    rng = np.random.default_rng(1)
    genome = random_seq(rng, 6000, 0.01)
    N, SL = 10, 512
    q = np.full((N, SL), 4, np.uint8)
    qlens = np.zeros(N, np.int32)
    ws = np.zeros(N, np.int32)
    for r in range(N):
        g0 = int(rng.integers(0, 5400))
        read = mutate(rng, genome[g0:g0 + int(rng.integers(50, 500))])[:SL]
        q[r, :len(read)] = read
        qlens[r] = len(read)
        ws[r] = g0 - 64 + int(rng.integers(-20, 20))
    ws[0] = -100                           # window starts before the genome
    cmin = np.where(np.arange(N) % 2, 0, 3000).astype(np.int32)
    cmax = np.where(np.arange(N) % 2, 3000, 6000).astype(np.int32)
    want = np.asarray(jband.banded_extend_score(
        q, qlens, ws, cmin, cmax, jband.pack_codes_host(genome), sc,
        backend='jax'))
    got = tband.banded_extend_score(*_t(q, qlens, ws, cmin, cmax, genome),
                                    port_config(sc)).numpy()
    assert want.shape == got.shape == (5, N)
    np.testing.assert_array_equal(want, got)


def _strand_reads(ref, rng, n=24, L=1536):
    seqs = []
    for i in range(n):
        p = int(rng.integers(0, len(ref.codes) - 1300))
        s = mutate(rng, ref.codes[p:p + int(rng.integers(100, 1300))])
        seqs.append(revcomp_str(decode(s)) if i % 2 else decode(s))
    cat, off = encode_cat(seqs)
    reads = np.full((n, L), 4, np.uint8)
    lens = np.diff(off).astype(np.int32)
    for i in range(n):
        reads[i, :lens[i]] = cat[off[i]:off[i + 1]][:L]
    return reads, np.minimum(lens, L)


@pytest.mark.parametrize('path', ['counts', 'table'])
@pytest.mark.parametrize('which', ['random', 'repetitive'])
def test_seed_candidates_match(path, which, ref_and_index, repetitive_ref):
    ref, sidx = ref_and_index if which == 'random' else repetitive_ref
    acfg = AlignConfig()
    C = jalign._occ_cap(sidx, acfg)
    reads, lens = _strand_reads(ref, np.random.default_rng(2))
    L = reads.shape[1]
    k = acfg.seed_k
    S = (L - k) // acfg.seed_stride + 1
    counts = sidx.counts.astype(np.int32)
    positions = sidx.positions.astype(np.int32)
    kw = dict(k=k, stride=acfg.seed_stride, occ_drop=acfg.occ_drop,
              band_w=acfg.band_width // 2, max_cand=acfg.max_candidates,
              S=S, C=C)
    if path == 'table':
        jtab = jalign._build_table_device(counts, positions, C)
        want = jseed.seed_candidates(reads, lens, None, None, table=jtab,
                                     **kw)
        got = tseed.seed_candidates(
            *_t(reads, lens), None, None,
            table=talign._build_table(*_t(counts, positions), C), **kw)
    else:
        want = jseed.seed_candidates(reads, lens, counts, positions, **kw)
        got = tseed.seed_candidates(*_t(reads, lens, counts, positions),
                                    **kw)
    assert set(want) == set(got)
    for name in want:
        np.testing.assert_array_equal(np.asarray(want[name]),
                                      got[name].numpy(), err_msg=name)
    assert np.asarray(want['valid']).sum() > len(reads)


@pytest.mark.parametrize('biased', [False, True])
def test_select_alignments_match(biased):
    rng = np.random.default_rng(3)
    B, C = 40, 12
    qs = rng.integers(0, 2000, (B, C)).astype(np.int32)
    qe = (qs + rng.integers(10, 900, (B, C))).astype(np.int32)
    sc = rng.integers(0, 600, (B, C)).astype(np.float32)
    qe[:, 5] = qe[:, 4]                         # ties in the sort key
    sc[:, 7] = sc[:, 6]
    valid = rng.random((B, C)) < 0.8
    bias = (np.where(rng.random((B, C)) < 0.3, 1.05, 1.0).astype(np.float32)
            if biased else None)
    kw = dict(ol_cost=2, max_overlap=300, min_score=21)
    want = np.asarray(jsel.select_alignments(qs, qe, sc, valid, bias=bias,
                                             **kw))
    got = tsel.select_alignments(
        *_t(qs, qe, sc, valid),
        bias=None if bias is None else torch.from_numpy(bias), **kw).numpy()
    np.testing.assert_array_equal(want, got)
    assert want.any()


@pytest.mark.parametrize('which', ['random', 'repetitive'])
def test_device_index_matches_jax(which, ref_and_index, repetitive_ref):
    ref, sidx = ref_and_index if which == 'random' else repetitive_ref
    acfg = AlignConfig()
    genome32, counts_j, pos_j = jalign._device_arrays(ref, sidx)
    (didx,) = talign.device_index(ref, sidx, CPU, acfg)
    assert didx.ref is ref and didx.contig_base == 0
    words = np.asarray(genome32).view(np.uint8)
    np.testing.assert_array_equal(words[:len(ref.codes)],
                                  didx.genome.numpy())
    assert (words[len(ref.codes):] == 4).all()
    np.testing.assert_array_equal(np.asarray(counts_j), didx.counts.numpy())
    np.testing.assert_array_equal(np.asarray(pos_j), didx.positions.numpy())
    assert didx.occ_cap == jalign._occ_cap(sidx, acfg)
    if didx.occ_cap <= 8:
        tab = jalign._device_table(sidx, didx.occ_cap, counts_j, pos_j)
        np.testing.assert_array_equal(np.asarray(tab), didx.table.numpy())
    else:
        assert didx.table is None
    # the port keeps its own cache: a fresh SeedIndex gains no attributes
    fresh = SeedIndex(k=sidx.k, counts=sidx.counts, positions=sidx.positions)
    talign.device_index(ref, fresh, CPU, acfg)
    assert set(vars(fresh)) == {'k', 'counts', 'positions', 'shards'}


def _fusion_reads(ref, rng):
    """Exact, reverse-strand, three-segment fusion, noisy, unmapped, 120 bp
    deletion and repeat-overlapping reads, all in one length bucket (few
    distinct JAX shapes to compile)."""
    c = ref.codes
    return [decode(c[3000:4200]), revcomp_str(decode(c[8000:9200])),
            decode(np.concatenate([c[1000:1400], c[25000:25500],
                                   c[5000:5400]])),
            decode(mutate(rng, c[12000:13300], sub=0.04, indel=0.02)),
            decode(random_seq(rng, 1200)),
            decode(np.concatenate([c[6000:6600], c[6720:7320]])),
            decode(c[1000:2300])]


@pytest.mark.parametrize('which', ['random', 'repetitive'])
def test_align_batch_matches(which, ref_and_index, repetitive_ref):
    ref, sidx = ref_and_index if which == 'random' else repetitive_ref
    seqs = _fusion_reads(ref, np.random.default_rng(4))
    want = jalign.align_batch(seqs, ref, sidx, CONFIG, backend='jax')
    got = talign.align_batch(seqs, ref,
                             talign.device_index(ref, sidx, CPU,
                                                 TCONFIG.align), TCONFIG)
    assert len(got) == len(want) >= len(seqs)
    for f in ('read_idx', 'chrom_idx', 'rstart', 'rend', 'strand_rev',
              'qstart_o', 'qend_o', 'qlen', 'score', 'mapq', 'is_primary',
              'overlaps_region'):
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                      err_msg=f)


def test_align_batch_regions_bias(ref_and_index, tmp_path):
    ref, sidx = ref_and_index
    regions = tmp_path / 'regions.bed'
    regions.write_text('chr1\t900\t2000\nchr2\t4000\t6000\nchrX\t1\t5\n')
    seqs = _fusion_reads(ref, np.random.default_rng(5))
    want = jalign.align_batch(seqs, ref, sidx, CONFIG,
                              regions_path=str(regions), backend='jax')
    got = talign.align_batch(seqs, ref,
                             talign.device_index(ref, sidx, CPU),
                             TCONFIG, regions_path=str(regions))
    assert want.overlaps_region.any()
    for f in ('read_idx', 'rstart', 'score', 'mapq', 'is_primary',
              'overlaps_region'):
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                      err_msg=f)


def test_mapq_model_matches_scalar_reference():
    rng = np.random.default_rng(6)
    n = 200
    s1 = rng.integers(-5, 1200, n)
    s2 = rng.integers(0, 1200, n)
    span = rng.integers(1, 700, n)
    rspan = rng.integers(1, 700, n)
    sub_n = rng.integers(0, 10, n)
    got = talign._bwa_style_mapq(s1, s2, span, rspan, sub_n, 2, 3, 22)
    want = [jalign._bwa_style_mapq(int(a), int(b), int(c), int(d), 2, 3, 22,
                                   int(e))
            for a, b, c, d, e in zip(s1, s2, span, rspan, sub_n)]
    np.testing.assert_array_equal(got, want)


def test_device_index_per_shard():
    """One device index per shard, each with its contig base, genome,
    tables and its own occurrence cap, as fslr_tpu uploads them."""
    ref = _mk_ref(np.random.default_rng(0), [12000, 3000, 3000],
                  repeat=(300, 20))
    sidx = build_seed_index(ref, k=11, max_shard_bases=12500)
    didx = talign.device_index(ref, sidx, CPU)
    assert len(didx) == len(sidx.shards) == 2
    for d, sh in zip(didx, sidx.shards):
        assert d.ref is sh.ref and d.contig_base == sh.contig_base
        genome32, counts_j, pos_j = jalign._device_arrays(sh.ref, sh.sidx)
        words = np.asarray(genome32).view(np.uint8)
        np.testing.assert_array_equal(words[:len(sh.ref.codes)],
                                      d.genome.numpy())
        np.testing.assert_array_equal(np.asarray(counts_j), d.counts.numpy())
        np.testing.assert_array_equal(np.asarray(pos_j), d.positions.numpy())
        assert d.occ_cap == jalign._occ_cap(sh.sidx, AlignConfig())
    assert len({d.occ_cap for d in didx}) == 2     # the repeat's shard


def _sharded_scenario():
    """tests/test_align.py::test_sharded_index_matches_unsharded: three
    contigs, shards of at most 25,000 bases; a read split across chr1 and
    the reverse strand of chr3, and an exact one."""
    ref = _mk_ref(np.random.default_rng(77), [20000, 20000, 20000])
    reads = [decode(ref.codes[2000:2800])
             + revcomp_str(decode(ref.codes[45000:45900])),
             decode(ref.codes[41000:42200])]
    return ref, build_seed_index(ref, k=11, max_shard_bases=25000), reads


ALN_FIELDS = ('read_idx', 'chrom_idx', 'rstart', 'rend', 'strand_rev',
              'qstart_o', 'qend_o', 'qlen', 'score', 'mapq', 'is_primary',
              'overlaps_region')


def _assert_alignments_equal(want, got, exact):
    assert len(got) == len(want)
    for f in ALN_FIELDS:
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                      err_msg=f)
        assert getattr(want, f).dtype == getattr(got, f).dtype, f
    if exact:
        assert got.cigar_lists() == want.cigar_lists()


@pytest.mark.parametrize('exact', [False, True], ids=['approx', 'exact'])
def test_sharded_align_batch_matches(exact):
    ref, sidx, reads = _sharded_scenario()
    assert len(sidx.shards) == 3
    config = PipelineConfig(exact_cigars=exact)
    want = jalign.align_batch(reads, ref, sidx, config, backend='jax')
    got = talign.align_batch(reads, ref,
                             talign.device_index(ref, sidx, CPU),
                             port_config(config))
    _assert_alignments_equal(want, got, exact)
    assert {ref.names[c] for c in got.chrom_idx} == {'chr1', 'chr3'}


def test_sharded_align_batch_without_chain_filter():
    """With chain_drop_ratio 0 the port's sharded path keeps every band and
    equals the unsharded index's alignments.  fslr_tpu's sharded path
    raises there (ROADMAP.md section 3): its chain filter returns no mask,
    np.flatnonzero(None) empties the candidates and sid[None] gains an
    axis, so a shard's row indices point past them."""
    ref, sidx, reads = _sharded_scenario()
    config = PipelineConfig(exact_cigars=False)
    config = config.replace(align=dataclasses.replace(config.align,
                                                      chain_drop_ratio=0.0))
    want = jalign.align_batch(reads, ref, build_seed_index(ref, k=11),
                              config, backend='jax')
    got = talign.align_batch(reads, ref, talign.device_index(ref, sidx, CPU),
                             port_config(config))

    def rows(a):
        return sorted(zip(*(getattr(a, f).tolist() for f in ALN_FIELDS)))
    assert rows(got) == rows(want) and len(got) >= 3
    with pytest.raises(IndexError):
        jalign.align_batch(reads, ref, sidx, config, backend='jax')


def _motif_scenario():
    """Three 20 kbp contigs (shards of at most 25,000 bases), each holding
    ten copies of one 24 bp motif, so that its k-mers pass every shard's
    occurrence cap and the unsharded one's; 20 reads of 800 bases of chr1,
    80 random ones, the motif and 80 random ones."""
    rng = np.random.default_rng(5)
    parts = [random_seq(rng, 20000) for _ in range(3)]
    motif = random_seq(rng, 24)
    for p in parts:
        for c in range(10):
            p[3000 + 500 * c:3024 + 500 * c] = motif
    lengths = np.full(3, 20000, np.int64)
    ref = Reference(names=['chr1', 'chr2', 'chr3'], lengths=lengths,
                    offsets=np.concatenate([[0], np.cumsum(lengths)]),
                    codes=np.concatenate(parts))
    reads = [decode(ref.codes[12000 + 100 * i:12800 + 100 * i])
             + decode(random_seq(rng, 80)) + decode(motif)
             + decode(random_seq(rng, 80)) for i in range(20)]
    return ref, reads


def test_shards_move_short_anchors_as_in_fslr_tpu():
    """Seeding samples at most C of a k-mer's positions, per shard, so a
    sharded index seeds a repeat's copies otherwise than the unsharded
    one: fslr_tpu's sharded and unsharded align_batch differ in the
    motif's short anchors and agree in every alignment of >= 50 bp, and
    the port's give the same rows as fslr_tpu's with either index.  This
    is why chip_smoke.py holds the 2-shard align_batch to the unsharded
    one in alignments of >= 50 bp only."""
    ref, reads = _motif_scenario()
    config = PipelineConfig(exact_cigars=True)
    rows = []
    for cap in (10 ** 9, 25000):
        sidx = build_seed_index(ref, k=11, max_shard_bases=cap)
        assert len(sidx.shards or [sidx]) == (1 if cap > 10 ** 5 else 3)
        want = jalign.align_batch(reads, ref, sidx, config, backend='jax')
        got = talign.align_batch(reads, ref,
                                 talign.device_index(ref, sidx, CPU),
                                 port_config(config))
        _assert_alignments_equal(want, got, True)
        rows.append(set(zip(*(getattr(got, f).tolist()
                              for f in ALN_FIELDS),
                          map(tuple, got.cigar_lists()))))
    n = ALN_FIELDS.index('rstart')
    long = [{r for r in rs if r[n + 1] - r[n] + 1 >= 50} for rs in rows]
    assert long[0] == long[1] and len(long[0]) >= 20
    assert rows[0] != rows[1]
    assert all(r[n + 1] - r[n] + 1 < 50 for r in rows[0] ^ rows[1])


def test_masked_align_batch_matches():
    """Masked candidates are pooled after renaming their contigs; those on
    a contig the reference lacks are dropped.  The masked reference of a
    sharded one is a reference of its own."""
    ref, sidx, reads = _sharded_scenario()
    lo, hi = 1500, 3200
    parts = {'chr1': np.concatenate([np.full(lo - 1, 4, np.uint8),
                                     ref.codes[lo:hi]]),
             'chrZ': ref.codes[41000:43000]}
    lengths = np.array([len(p) for p in parts.values()], np.int64)
    mref = Reference(names=list(parts), lengths=lengths,
                     offsets=np.concatenate([[0], np.cumsum(lengths)]),
                     codes=np.concatenate(list(parts.values())))
    msidx = build_seed_index(mref, k=11)
    config = PipelineConfig()
    want = jalign.align_batch(reads, ref, sidx, config, backend='jax',
                              masked=(mref, msidx))
    got = talign.align_batch(
        reads, ref, talign.device_index(ref, sidx, CPU), port_config(config),
        masked=(mref, talign.device_index(mref, msidx, CPU)))
    _assert_alignments_equal(want, got, True)
    plain = talign.align_batch(reads, ref,
                               talign.device_index(ref, sidx, CPU),
                               port_config(config))
    assert len(got) >= len(plain)


@pytest.mark.parametrize('scores,ok', [
    (dict(match=2.0, mismatch=-3.0, fg=7.0, ext=2.0), True),
    (dict(match=2.5, mismatch=-3.0, fg=7.0, ext=2.0), False),
    (dict(match=2.0, mismatch=-300.0, fg=7.0, ext=2.0), False)])
def test_banded_kernel_takes_small_integer_scores(scores, ok):
    """The kernels' int32 DP (and its score bytes) needs integer scores
    with |match|, |mismatch| < 128; the wrapper raises before launching."""
    if ok:
        assert tband._int_scores(**scores) == (2, -3, 7, 2)
        return
    q, w, qlens = _t(*_banded_rows(0, N=2))
    with pytest.raises(ValueError, match='small integers'):
        tband._banded_cuda(q, w, qlens, **scores)


@pytest.mark.parametrize('N,wide', [(1, False), (4223, False),
                                    (4224, True), (30000, True)])
def test_layout_is_wide_from_32_rows_an_sm(monkeypatch, N, wide):
    """The banded DP's thread layout per launch: 16 columns a lane from 32
    rows an SM (132 SMs here), else the kernel's narrow layout."""
    from types import SimpleNamespace
    from fslr_tpu_torch.ops import traceback as ttb
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda dev: SimpleNamespace(multi_processor_count=132))
    assert tband._layout(N, None, tband.LAYOUTS) == (16 if wide else 8)
    assert tband._layout(N, None, ttb.LAYOUTS) == (16 if wide else 4)


def test_row_order_is_descending_and_stable():
    qlens = torch.tensor([5, 9, 0, 9, 5, 1], dtype=torch.int32)
    order = tband._row_order(qlens)
    assert order.dtype == torch.int32
    assert order.tolist() == [1, 3, 0, 4, 5, 2]
