"""fslr_tpu_torch's align stage with exact CIGARs (``PipelineConfig()``
defaults: traceback emit on the selected rows, walk-derived begins, z-drop
split) against fslr_tpu on the CPU.  Every column and every CIGAR must be
equal."""

import numpy as np
import pytest
import torch

from fslr_tpu.config import PipelineConfig
from fslr_tpu.encode import decode
from fslr_tpu.index.reference import build_seed_index
from fslr_tpu.stages import align as jalign
from fslr_tpu_torch.stages import align as talign
from tests.test_torch_env import port_config
from tests.oracles import random_seq
from tests.test_torch_align_ops import _fusion_reads, _mk_ref

CONFIG = PipelineConfig()
TCONFIG = port_config(CONFIG)
CPU = torch.device('cpu')
COLUMNS = ('read_idx', 'chrom_idx', 'rstart', 'rend', 'strand_rev',
           'qstart_o', 'qend_o', 'qlen', 'score', 'mapq', 'is_primary',
           'overlaps_region')


@pytest.fixture(scope='module')
def ref_and_index():
    ref = _mk_ref(np.random.default_rng(42), [20000, 20000])
    return ref, build_seed_index(ref, k=11)


def _both(seqs, ref, sidx, regions_path=None):
    want = jalign.align_batch(seqs, ref, sidx, CONFIG,
                              regions_path=regions_path, backend='jax')
    got = talign.align_batch(seqs, ref,
                             talign.device_index(ref, sidx, CPU,
                                                 TCONFIG.align),
                             TCONFIG, regions_path=regions_path)
    assert len(got) == len(want)
    for f in COLUMNS:
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                      err_msg=f)
    assert got.cigar_lists() == want.cigar_lists()
    for w_, g_ in zip(want.cig_rle, got.cig_rle):
        np.testing.assert_array_equal(w_, g_)
    return got


def _spans_agree(out):
    """Each CIGAR covers its record's query and reference spans."""
    for i, cig in enumerate(out.cigar_lists()):
        assert sum(n for n, op in cig if op in 'MI') == \
            int(out.qend_o[i] - out.qstart_o[i])
        assert sum(n for n, op in cig if op in 'MD') == \
            int(out.rend[i] - out.rstart[i] + 1)


def test_zdrop_splits_near_diagonal_fusion(ref_and_index):
    """A 120 bp deletion (penalty 5 + 2 * 120 > zdrop 200) between two
    segments whose diagonals fuse into one band: two alignments, as in
    tests/test_align.py."""
    ref, sidx = ref_and_index
    read = decode(np.concatenate([ref.codes[6000:6800],
                                  ref.codes[6920:7720]]))
    out = _both([read], ref, sidx)
    assert len(out) == 2
    assert int(out.is_primary.sum()) == 1
    assert sorted(out.rstart.tolist()) == [6000, 6920]
    _spans_agree(out)


def test_zdrop_keeps_small_deletion(ref_and_index):
    """A 90 bp deletion (5 + 2 * 90 <= 200) stays one alignment bridged by
    a D run."""
    ref, sidx = ref_and_index
    read = decode(np.concatenate([ref.codes[9000:9700],
                                  ref.codes[9790:10400]]))
    out = _both([read], ref, sidx)
    assert len(out) == 1
    assert any(op == 'D' and n >= 85 for n, op in out.cigar_lists()[0])
    _spans_agree(out)


@pytest.mark.parametrize('which', ['random', 'repetitive'])
def test_align_batch_exact_matches(which, ref_and_index):
    if which == 'random':
        ref, sidx = ref_and_index
    else:
        ref = _mk_ref(np.random.default_rng(9), [30000, 5000],
                      repeat=(400, 30))
        sidx = build_seed_index(ref, k=11)
    out = _both(_fusion_reads(ref, np.random.default_rng(4)), ref, sidx)
    assert len(out) >= 7
    assert any(op != 'M' for cig in out.cigar_lists() for _, op in cig)
    _spans_agree(out)


def test_align_batch_exact_regions(ref_and_index, tmp_path):
    ref, sidx = ref_and_index
    regions = tmp_path / 'regions.bed'
    regions.write_text('chr1\t900\t2000\nchr1\t6000\t6700\n'
                       'chr2\t4000\t6000\n')
    seqs = _fusion_reads(ref, np.random.default_rng(5)) + [decode(
        np.concatenate([ref.codes[6000:6800], ref.codes[6920:7720]]))]
    out = _both(seqs, ref, sidx, regions_path=str(regions))
    assert out.overlaps_region.any()


def test_tied_band_columns_give_a_clips_only_record(ref_and_index):
    """Two 40 bp copies of the reference, 80 bp of junk apart, on band
    lanes 24 apart: both reach the best score 80, the earlier query end
    on the higher lane.  ``_finalize`` takes the query end and the lane
    from different columns, so the walk starts off the best cell and stops
    at once: an alignment with an AS but no M/I/D (qstart == qend, rend ==
    rstart - 1).  fslr_tpu gives the same record; chip_smoke.py bounds
    such records in the BAM."""
    ref, sidx = ref_and_index
    rng = np.random.default_rng(0)
    c = ref.codes
    a = 15000
    b = a + 40 + 80 - 24
    read = decode(np.concatenate([
        random_seq(rng, 100), c[a:a + 40], random_seq(rng, 80),
        c[b:b + 40], random_seq(rng, 100)]))
    out = _both([read], ref, sidx)
    assert len(out) == 1
    assert out.cigar_lists() == [[]]
    assert int(out.score[0]) == 80
    assert int(out.qstart_o[0]) == int(out.qend_o[0])
    assert int(out.rend[0]) == int(out.rstart[0]) - 1


def test_exact_cigars_off_keeps_no_emits(ref_and_index):
    ref, sidx = ref_and_index
    config = TCONFIG.replace(exact_cigars=False)
    out = talign.align_batch(
        _fusion_reads(ref, np.random.default_rng(4)), ref,
        talign.device_index(ref, sidx, CPU, config.align), config)
    assert len(out) and not out.cig_rle[0].any()
    assert out.cigar_lists() == [None] * len(out)
