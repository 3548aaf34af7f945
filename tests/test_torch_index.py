"""The port's seed index against fslr_tpu's on the CPU: the reference
loader, the k-mer index built with torch ops (N bases, contig boundaries,
contigs shorter than k, one contig, an empty one), the sharded build at a
tiny shard cap, the sharded ``.npz`` cache written by either package and
read by the other, and the masked reference.  Every comparison is exact."""

import contextlib
import gzip
import io
import os
import shutil

import numpy as np
import pytest
import torch

from fslr_tpu import pipeline as jpipeline
from fslr_tpu.index import reference as jref
from fslr_tpu_torch import pipeline as tpipeline
from fslr_tpu_torch.index import reference as tref
from fslr_tpu_torch.instrument import StageTimer
from tests.oracles import random_seq

CPU = torch.device('cpu')
K = 11


def _contigs(seed, sizes, n_frac=0.02):
    rng = np.random.default_rng(seed)
    return [random_seq(rng, s, n_frac) for s in sizes]


def _refs(parts):
    """The same contigs as a fslr_tpu and a port Reference."""
    lengths = np.array([len(p) for p in parts], np.int64)
    kw = dict(names=[f'c{i}' for i in range(len(parts))], lengths=lengths,
              offsets=np.concatenate([[0], np.cumsum(lengths)]),
              codes=(np.concatenate(parts) if parts
                     else np.zeros(0, np.uint8)))
    return jref.Reference(**kw), tref.Reference(**kw)


def _assert_index_equal(want, got):
    assert got.k == want.k
    assert got.counts.dtype == want.counts.dtype == np.int64
    assert got.positions.dtype == want.positions.dtype == np.int32
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.positions, want.positions)


CASES = {
    'n_and_boundaries': [6000, 3, 10, 11, 4000, 12, 2500],
    'one_contig': [9000],
    'with_an_empty_contig': [3000, 0, 4000],
    'shorter_than_k': [4, 10, 7],
    'no_contigs': [],
}


@pytest.mark.parametrize('case', CASES)
def test_build_matches_fslr_tpu(case):
    jr, tr = _refs(_contigs(1, CASES[case]))
    want = jref.build_seed_index(jr, K)
    got = tref.build_seed_index(tr, K, CPU)
    assert not want.shards and not got.shards
    _assert_index_equal(want, got)
    if case == 'n_and_boundaries':      # the exclusions did something
        assert 0 < len(got.positions) < len(tr.codes) - K + 1
        assert (tr.codes == 4).any()


@pytest.mark.parametrize('cap', [5000, 9000, 15000])
def test_sharded_build_matches_fslr_tpu(cap):
    jr, tr = _refs(_contigs(2, [4000, 3000, 0, 6000, 10, 5000]))
    want = jref.build_seed_index(jr, K, max_shard_bases=cap)
    got = tref.build_seed_index(tr, K, CPU, max_shard_bases=cap)
    assert want.shards and len(got.shards) == len(want.shards) >= 2
    assert got.counts.size == got.positions.size == 0
    for a, b in zip(want.shards, got.shards):
        assert b.contig_base == a.contig_base
        assert b.ref.names == a.ref.names
        np.testing.assert_array_equal(b.ref.offsets, a.ref.offsets)
        np.testing.assert_array_equal(b.ref.codes, a.ref.codes)
        _assert_index_equal(a.sidx, b.sidx)


def test_build_times_each_shard():
    _, tr = _refs(_contigs(3, [3000, 3000, 3000]))
    timer = StageTimer()
    sidx = tref.build_seed_index(tr, K, CPU, max_shard_bases=5000,
                                 timer=timer)
    assert len(sidx.shards) == 3
    assert set(timer.timings) == {f'index_build_shard{i}' for i in range(3)}


FASTA = {
    'wrapped': '>chr1 the first\nACGTACGTNN\nacgtRYK\n>chr2\tx y\nGGGG\n',
    'empty_records': '>a\n>b\nACGT\n\n>c\n\nTT\n>d',
    'no_final_newline': '>only\nACGTNACGT',
    'header_only': '>h',
    'windows_newlines': '>w\r\nACGT\r\nTTGA\r\n>v\r\nCC\r\n',
    'old_mac_newlines': '>m one\rACGT\rTT\r>n\rGG',
    'fastq': '@r1\nACGT\n+\nIIII\n@r2\nGG\n+\nII\n',
}


@pytest.mark.parametrize('gz', [False, True], ids=['plain', 'gz'])
@pytest.mark.parametrize('layout', FASTA)
def test_load_reference_matches_fslr_tpu(tmp_path, layout, gz):
    path = str(tmp_path / ('ref.fa.gz' if gz else 'ref.fa'))
    data = FASTA[layout].encode()
    with (gzip.open if gz else open)(path, 'wb') as fh:
        fh.write(data)
    want = jref.load_reference(path)
    got = tref.load_reference(path)
    assert got.names == want.names
    for f in ('lengths', 'offsets', 'codes'):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype, f


@pytest.mark.parametrize('gz', [False, True], ids=['plain', 'gz'])
def test_load_reference_refuses_a_sequence_outside_ascii(tmp_path, gz):
    path = str(tmp_path / ('ref.fa.gz' if gz else 'ref.fa'))
    with (gzip.open if gz else open)(path, 'wb') as fh:
        fh.write('>a\nACGT\n>b\nACÉT\n'.encode())
    for load in (jref.load_reference, tref.load_reference):
        with pytest.raises(ValueError):
            load(path)


def _write_fasta(path, parts):
    from fslr_tpu_torch.encode import decode
    with open(path, 'w') as fh:
        for i, p in enumerate(parts):
            s = decode(p)
            fh.write(f'>c{i}\n' + '\n'.join(s[j:j + 60]
                                             for j in range(0, len(s), 60))
                     + '\n')


CAP = 9000


@contextlib.contextmanager
def _forced_shards(monkeypatch):
    """Both packages' pipelines build sharded indexes at CAP bases."""
    jbuild, tbuild = jref.build_seed_index, tref.build_seed_index
    monkeypatch.setattr(jref, 'build_seed_index',
                        lambda ref, k, max_shard_bases=CAP: jbuild(
                            ref, k, CAP))
    monkeypatch.setattr(tref, 'build_seed_index',
                        lambda ref, k, device, max_shard_bases=CAP,
                        timer=None: tbuild(ref, k, device, CAP, timer))
    yield


def _load(load, *args):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = load(*args)
    assert 'WARNING' not in err.getvalue(), err.getvalue()
    return out


@pytest.mark.parametrize('writer', ['fslr_tpu', 'port'])
def test_sharded_cache_read_by_the_other_package(tmp_path, monkeypatch,
                                                 writer):
    """One package writes the sharded cache; the other, whose own build
    would not shard, reads those shards back unchanged."""
    path = str(tmp_path / 'ref.fa')
    _write_fasta(path, _contigs(4, [4000, 3000, 6000, 5000]))
    jload = jpipeline._load_indexed
    tload = tpipeline._load_indexed
    with _forced_shards(monkeypatch):
        if writer == 'fslr_tpu':
            _, want = _load(jload, path, K)
        else:
            _, want = _load(tload, path, K, CPU)
    monkeypatch.undo()
    cache = f'{path}.fslr_k{K}.npz'
    with np.load(cache) as z:
        assert {'shard_bounds', 'counts_0', 'positions_0'} <= set(z)
    mtime = os.path.getmtime(cache)
    if writer == 'fslr_tpu':
        ref, got = _load(tload, path, K, CPU)
    else:
        ref, got = _load(jload, path, K)
    assert os.path.getmtime(cache) == mtime          # read, not rebuilt
    assert len(got.shards) == len(want.shards) >= 2
    for a, b in zip(want.shards, got.shards):
        assert b.contig_base == a.contig_base
        assert b.ref.names == a.ref.names
        np.testing.assert_array_equal(b.ref.codes, a.ref.codes)
        _assert_index_equal(a.sidx, b.sidx)
    full = jref.build_seed_index(jref.load_reference(path), K,
                                 max_shard_bases=CAP)
    for a, b in zip(full.shards, got.shards):
        _assert_index_equal(a.sidx, b.sidx)


def test_masked_reference_fasta_equal_to_fslr_tpu(tmp_path):
    """The masked reference keeps the reference's layout: start - 1 Ns,
    then ref[start:end] (make_ref_mask.py)."""
    path = str(tmp_path / 'ref.fa')
    _write_fasta(path, _contigs(5, [5000, 4000]))
    bed = tmp_path / 'mask.bed'
    bed.write_text('# targets\nc0\t1000\t2500\nc1\t0\t700\nshort\n')
    out = {}
    for pkg, mod in (('jax', jref), ('torch', tref)):
        out[pkg] = str(tmp_path / f'{pkg}_masked.fa')
        mod.write_masked_reference(str(bed), out[pkg], path)
    with open(out['jax'], 'rb') as a, open(out['torch'], 'rb') as b:
        want = a.read()
        assert b.read() == want
    masked = tref.load_reference(out['torch'])
    assert masked.names == ['c0', 'c1']
    assert masked.lengths.tolist() == [999 + 1500, 700]
    shutil.rmtree(tmp_path)


def test_grch38_layout_dataset(tmp_path):
    """make_grch38_layout_dataset at a small size: 60-column FASTA that
    both packages read alike, the mask BED, and reads made of the 21q1
    target, chr1 and chrX segments inside the mask, and the rc 17p6
    target; the same bytes on a second call."""
    from fslr_tpu_torch.encode import decode, revcomp_str
    from fslr_tpu_torch.panel import load_panel
    from fslr_tpu_torch.tools.synth import (GRCH38, group_span,
                                            make_grch38_layout_dataset)
    assert len(GRCH38) == 24
    assert sum(n for _, n in GRCH38) == 3_088_269_832
    small = (('chr1', 1_400_000), ('chr2', 61), ('chrX', 1_600_000),
             ('chrY', 59))
    paths = [make_grch38_layout_dataset(str(tmp_path / d), 45, 20, small)
             for d in ('a', 'b') if not os.makedirs(tmp_path / d)]
    (ref, fq, mask), (ref_b, fq_b, mask_b) = paths
    for x, y in ((ref, ref_b), (os.path.join(fq, 'b0.fastq'),
                                os.path.join(fq_b, 'b0.fastq'))):
        with open(x, 'rb') as fa, open(y, 'rb') as fb:
            assert fa.read() == fb.read()
    with open(ref) as fh:
        lines = fh.read().splitlines()
    assert {len(ln) for ln in lines if not ln.startswith('>')} == \
        {60} | {n % 60 for _, n in small if n % 60}
    got, want = tref.load_reference(ref), jref.load_reference(ref)
    assert got.names == want.names == [n for n, _ in small]
    assert got.lengths.tolist() == [n for _, n in small]
    np.testing.assert_array_equal(got.codes, want.codes)
    with open(mask) as fh:
        assert fh.read() == 'chr1\t900000\t1300000\nchrX\t500000\t1500000\n'
    panel = load_panel().subset(['21q1', '17p6'])
    t21, t17rc = panel.targets['21q1'], revcomp_str(panel.targets['17p6'])

    def seg(chrom, lo, n):
        ci = got.names.index(chrom)
        return decode(got.codes[got.offsets[ci] + lo:
                                got.offsets[ci] + lo + n])
    span = group_span(1_600_000, 20)
    with open(os.path.join(fq, 'b0.fastq')) as fh:
        records = fh.read().splitlines()
    for i in (0, 19, 44):
        assert records[4 * i] == f'@r{i}'
        assert records[4 * i + 1] == (
            t21 + seg('chr1', 1_000_000, 800)
            + seg('chrX', 600_000 + (i % 20) * span, 1000)
            + seg('chr1', 1_200_000, 800) + t17rc)
    assert 600_000 + 19 * span + 1000 <= 1_500_000
