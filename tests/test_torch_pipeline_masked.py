"""``reference_mask`` and a sharded index through the port's run_pipeline
on the CPU, byte for byte against fslr_tpu's run of the same settings.

The masked run uses the scenario of tests/test_pipeline.py::
test_pipeline_masked_reference_and_multifile (one 300 kbp contig, a 40 kbp
mask, regions, two input files of three reads), with --skip-clustering.
The golden scenario of tests/test_golden_snapshot.py runs with a mask over
both of its fusion reads' chrA and chrB segments and with clustering, and
once more with both packages' ``build_seed_index`` cut to shards of 150
kbp (each contig its own shard) and exact CIGARs."""

import glob
import os
import struct

import numpy as np
import pandas as pd
import pytest
import torch

from fslr_tpu.config import PipelineConfig as JaxPipelineConfig
from fslr_tpu.encode import decode, revcomp_str
from fslr_tpu.index import reference as jref
from fslr_tpu.panel import load_panel
from fslr_tpu.pipeline import run_pipeline as jax_run_pipeline
from fslr_tpu.stages import align as jalign
from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.index import reference as tref
from fslr_tpu_torch.io.fastq import read_fastx
from fslr_tpu_torch.pipeline import run_pipeline
from fslr_tpu_torch.stages import align as talign
from fslr_tpu_torch.tools.synth import make_masked_dataset
from tests.oracles import random_seq
from tests.test_golden_snapshot import _build
from tests.test_torch_align_ops import _assert_alignments_equal
from tests.test_torch_env import port_config
from tests.test_torch_pipeline import ARTIFACTS, _bam_records, _read

CPU = torch.device('cpu')
CLUSTER_ARTIFACTS = ('.mappings.cluster.bed', '.mappings.representative.bed')
SHARD_BASES = 150_000


def _masked_scenario(root):
    ref, fq, mask, regions = make_masked_dataset(root)
    return ref, fq, dict(reference_mask=mask, regions=regions)


def test_masked_dataset_is_the_fslr_tpu_scenario(tmp_path):
    """tools.synth.make_masked_dataset writes tests/test_pipeline.py::
    test_pipeline_masked_reference_and_multifile's data."""
    ref, fq, mask, regions = make_masked_dataset(str(tmp_path))
    chrA = random_seq(np.random.default_rng(99), 300_000)
    assert _read(ref) == ('>chrA\n' + decode(chrA) + '\n').encode()
    assert _read(mask) == b'chrA\t100000\t140000\n'
    assert _read(regions) == b'chrA\t110000\t130000\n'
    panel = load_panel().subset(['21q1', '17p6'])
    seq = (panel.targets['21q1'] + decode(chrA[115_000:116_200])
           + revcomp_str(panel.targets['17p6']))
    for f in range(2):
        assert _read(os.path.join(fq, f'b{f}.fastq')) == ''.join(
            f'@f{f}r{i}\n{seq}\n+\n{"I" * len(seq)}\n'
            for i in range(3)).encode()


@pytest.mark.parametrize('with_regions', [False, True],
                         ids=['no_regions', 'regions'])
def test_masked_copy_is_selected_only_with_regions(tmp_path, with_regions):
    """A masked contig holds its reference's bases one position earlier,
    so a read's alignment to it ties its alignment to the reference.
    Without regions the reference's, pooled first, is selected alone; with
    regions over both, each gains the bias and both are selected, the
    masked one at rstart - 1.  fslr_tpu selects the same, column for
    column and CIGAR for CIGAR."""
    ref_path, fq, mask, regions = make_masked_dataset(str(tmp_path))
    masked_path = str(tmp_path / 'masked.fa')
    tref.write_masked_reference(mask, masked_path, ref_path)
    reads = [r.sequence for r in read_fastx(os.path.join(fq, 'b0.fastq'))]
    config = JaxPipelineConfig(exact_cigars=True)
    regions = regions if with_regions else None
    jr, jm = jref.load_reference(ref_path), jref.load_reference(masked_path)
    want = jalign.align_batch(
        reads, jr, jref.build_seed_index(jr, 11), config, regions, 'jax',
        masked=(jm, jref.build_seed_index(jm, 11)))
    tr, tm = tref.load_reference(ref_path), tref.load_reference(masked_path)
    got = talign.align_batch(
        reads, tr, talign.device_index(tr, tref.build_seed_index(tr, 11, CPU),
                                       CPU), port_config(config), regions,
        masked=(tm, talign.device_index(tm, tref.build_seed_index(
            tm, 11, CPU), CPU)))
    _assert_alignments_equal(want, got, True)
    starts = {115_000 - 1, 115_000} if with_regions else {115_000}
    assert set(got.rstart[got.rend - got.rstart > 1000].tolist()) == starts


def _sharded(monkeypatch):
    """Cut both packages' index builds to SHARD_BASES."""
    jbuild, tbuild = jref.build_seed_index, tref.build_seed_index
    monkeypatch.setattr(jref, 'build_seed_index',
                        lambda ref, k, max_shard_bases=0: jbuild(
                            ref, k, SHARD_BASES))
    monkeypatch.setattr(tref, 'build_seed_index',
                        lambda ref, k, device, max_shard_bases=0, timer=None:
                        tbuild(ref, k, device, SHARD_BASES, timer))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """(scenario, package) -> output base; each package on its own copy
    of the data, so neither reads the other's index cache."""
    bases = {}
    for scen in ('masked', 'masked_cluster', 'sharded'):
        for pkg in ('jax', 'torch'):
            root = str(tmp_path_factory.mktemp(f'{scen}_{pkg}'))
            with pytest.MonkeyPatch.context() as mp:
                if scen == 'masked':
                    ref, fq, kw = _masked_scenario(root)
                else:
                    ref, fq = _build(root)
                    kw = dict(exact_cigars=True)
                if scen == 'sharded':
                    _sharded(mp)
                if scen == 'masked_cluster':
                    kw = dict(reference_mask=os.path.join(root, 'mask.bed'))
                    with open(kw['reference_mask'], 'w') as fh:
                        fh.write('chrA\t90000\t110000\n'
                                 'chrB\t190000\t210000\n')
                cls = JaxPipelineConfig if pkg == 'jax' else PipelineConfig
                config = cls(name='M', out=os.path.join(root, 'out'),
                             ref=ref, primers=('21q1', '17p6'),
                             basecalled=fq,
                             skip_clustering=scen != 'masked_cluster', **kw)
                if pkg == 'jax':
                    jax_run_pipeline(config, backend='jax')
                else:
                    run_pipeline(config, CPU)
            bases[scen, pkg] = os.path.join(config.out, 'M')
    return bases


@pytest.mark.parametrize('suffix', ARTIFACTS + CLUSTER_ARTIFACTS)
@pytest.mark.parametrize('scen', ['masked', 'masked_cluster', 'sharded'])
def test_artifacts_byte_equal_to_fslr_tpu(runs, scen, suffix):
    if suffix in CLUSTER_ARTIFACTS and scen != 'masked_cluster':
        assert not os.path.exists(runs[scen, 'torch'] + suffix)
        return
    assert _read(runs[scen, 'torch'] + suffix) == \
        _read(runs[scen, 'jax'] + suffix)


def _header_and_records(data):
    """A decompressed BAM split into its header bytes and its records'
    bytes, in file order."""
    o = 8 + struct.unpack_from('<i', data, 4)[0]
    (n_ref,) = struct.unpack_from('<i', data, o)
    o += 4
    for _ in range(n_ref):
        o += 8 + struct.unpack_from('<i', data, o)[0]
    head, recs = data[:o], []
    while o < len(data):
        n = 4 + struct.unpack_from('<i', data, o)[0]
        recs.append(data[o:o + n])
        o += n
    return head, recs


@pytest.mark.parametrize('scen', ['masked_cluster', 'sharded'])
def test_bam_records_equal_to_fslr_tpu(runs, scen):
    got = _bam_records(runs[scen, 'torch'])
    assert got == _bam_records(runs[scen, 'jax'])
    assert got.startswith(b'BAM\x01')


def test_multifile_bam_records_equal_as_a_multiset(runs):
    """With two input files, the files' filtered copies carry random
    names, and in both packages they set the order of records that tie
    on their coordinates: the records are equal as a multiset, in the
    same coordinate order."""
    head, got = _header_and_records(_bam_records(runs['masked', 'torch']))
    want_head, want = _header_and_records(_bam_records(runs['masked',
                                                           'jax']))
    assert head == want_head and len(got) == len(want) > 6
    assert sorted(got) == sorted(want)
    assert [r[4:12] for r in got] == [r[4:12] for r in want]


def test_masked_run_maps_every_file_in_the_regions(runs):
    """tests/test_pipeline.py's own expectations."""
    bed = pd.read_csv(runs['masked', 'torch'] + '.mappings.bed', sep='\t')
    assert len(set(bed['qname'].str.split('.').str[0])) == 6
    genomic = bed[bed['inferred_by_primer'] == 0]
    assert len(genomic) and (genomic['overlaps_region'] == 1).all()
    assert (genomic['chrom'] == 'chrA').all()


@pytest.mark.parametrize('scen', ['masked', 'masked_cluster'])
@pytest.mark.parametrize('pkg', ['jax', 'torch'])
def test_masked_runs_remove_the_temp_reference(runs, scen, pkg):
    """The masked reference and its index cache are removed."""
    base = runs[scen, pkg]
    assert os.path.exists(base + '.bwa_dodi.bam')
    assert not glob.glob(base + '_temp_ref.fa*')


def test_sharded_run_found_both_contigs(runs):
    bed = pd.read_csv(runs['sharded', 'torch'] + '.mappings.bed', sep='\t')
    assert {'chrA', 'chrB'} <= set(bed['chrom'])
    (cache,) = glob.glob(os.path.join(
        os.path.dirname(os.path.dirname(runs['sharded', 'torch'])),
        '*.fslr_k11.npz'))
    with np.load(cache) as z:
        assert z['shard_bounds'].tolist() == [[0, 1], [1, 2]]
