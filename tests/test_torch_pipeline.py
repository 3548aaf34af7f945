"""The port's slice end to end on the CPU: the golden scenario of
tests/test_golden_snapshot.py through fslr_tpu_torch.pipeline, held to the
golden mappings.bed and byte for byte to fslr_tpu's run of the same
settings (each package builds its own PipelineConfig from the same
keywords, skip_clustering=True), with exact CIGARs (the default:
traceback emit, z-drop split, columnar BAM) and with exact_cigars=False.
tests/test_torch_pipeline_cluster.py holds the runs with clustering and
consensus."""

import gzip
import os

import pandas as pd
import pytest
import torch

from fslr_tpu.config import PipelineConfig as JaxPipelineConfig
from fslr_tpu.pipeline import run_pipeline as jax_run_pipeline
from fslr_tpu_torch.config import BatchConfig, PipelineConfig
from fslr_tpu_torch.pipeline import run_pipeline
from tests.test_golden_snapshot import GOLDEN, _build

CPU = torch.device('cpu')
ARTIFACTS = ('.mappings.bed', '.filter_counts_summary.csv',
             '.without_primers.fq', '.bwa_dodi.bam.bai')


def _config(root, ref, fq, tag, exact_cigars=False, skip_clustering=True,
            **kw):
    cls = JaxPipelineConfig if tag.startswith('jax') else PipelineConfig
    return cls(name='G', out=os.path.join(root, tag), ref=ref,
               primers=('21q1', '17p6'), basecalled=fq,
               skip_clustering=skip_clustering, exact_cigars=exact_cigars,
               **kw)


def _read(path, mode='rb'):
    with open(path, mode) as fh:
        return fh.read()


def _bam_records(base):
    """The BAM decompressed (header + records), BGZF framing dropped."""
    return gzip.decompress(_read(base + '.bwa_dodi.bam'))


@pytest.fixture(scope='module')
def golden_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('golden'))
    ref, fq = _build(root)
    regions = os.path.join(root, 'regions.bed')
    with open(regions, 'w') as fh:
        fh.write('chrA\t100000\t100500\nchrB\t200500\t201200\n')
    bases = {}
    for tag, kw in (('jax', {}), ('torch', {}),
                    ('jax_regions', dict(regions=regions)),
                    ('torch_regions', dict(regions=regions)),
                    ('torch_chunked',
                     dict(batch=BatchConfig(align_stream_reads=3))),
                    ('jax_exact', dict(exact_cigars=True)),
                    ('torch_exact', dict(exact_cigars=True)),
                    ('jax_exact_regions', dict(exact_cigars=True,
                                               regions=regions)),
                    ('torch_exact_regions', dict(exact_cigars=True,
                                                 regions=regions))):
        config = _config(root, ref, fq, tag, **kw)
        if tag.startswith('jax'):
            jax_run_pipeline(config, backend='jax')
        else:
            run_pipeline(config, CPU)
        bases[tag] = os.path.join(config.out, 'G')
    return bases


def test_golden_mappings_bed(golden_runs):
    df = pd.read_csv(golden_runs['torch'] + '.mappings.bed', sep='\t')
    gold = pd.read_csv(GOLDEN, sep='\t')
    pd.testing.assert_frame_equal(
        df.drop(columns=['fslr_version']).reset_index(drop=True),
        gold.reset_index(drop=True), check_dtype=False)


@pytest.mark.parametrize('suffix', ARTIFACTS)
def test_artifacts_byte_equal_to_fslr_tpu(golden_runs, suffix):
    assert _read(golden_runs['torch'] + suffix) == \
        _read(golden_runs['jax'] + suffix)


def test_bam_records_equal_to_fslr_tpu(golden_runs):
    got = _bam_records(golden_runs['torch'])
    assert got == _bam_records(golden_runs['jax'])
    assert got.startswith(b'BAM\x01')


def test_regions_column_byte_equal_to_fslr_tpu(golden_runs):
    got = _read(golden_runs['torch_regions'] + '.mappings.bed', 'r')
    assert got == _read(golden_runs['jax_regions'] + '.mappings.bed', 'r')
    header, first = got.splitlines()[:2]
    assert header.endswith('\toverlaps_region')
    # pseudo-alignment rows turn the column float: 1.0 / 0.0 / empty
    assert first.split('\t')[-1] in ('1.0', '0.0', '')


def test_streamed_chunks_byte_identical(golden_runs):
    for suffix in ('.mappings.bed', '.filter_counts_summary.csv'):
        assert _read(golden_runs['torch_chunked'] + suffix) == \
            _read(golden_runs['torch'] + suffix)
    assert _bam_records(golden_runs['torch_chunked']) == \
        _bam_records(golden_runs['torch'])


def test_exact_golden_mappings_bed(golden_runs):
    df = pd.read_csv(golden_runs['torch_exact'] + '.mappings.bed', sep='\t')
    gold = pd.read_csv(GOLDEN, sep='\t')
    pd.testing.assert_frame_equal(
        df.drop(columns=['fslr_version']).reset_index(drop=True),
        gold.reset_index(drop=True), check_dtype=False)


@pytest.mark.parametrize('suffix', ARTIFACTS)
@pytest.mark.parametrize('tag', ['exact', 'exact_regions'])
def test_exact_artifacts_byte_equal_to_fslr_tpu(golden_runs, tag, suffix):
    assert _read(golden_runs[f'torch_{tag}'] + suffix) == \
        _read(golden_runs[f'jax_{tag}'] + suffix)


@pytest.mark.parametrize('tag', ['exact', 'exact_regions'])
def test_exact_bam_records_equal_to_fslr_tpu(golden_runs, tag):
    got = _bam_records(golden_runs[f'torch_{tag}'])
    assert got == _bam_records(golden_runs[f'jax_{tag}'])
    # traceback CIGARs differ from the approximate ones of the golden
    # scenario's mutated read
    assert got != _bam_records(golden_runs['torch'])


def test_exact_timings_have_emit(golden_runs):
    import json
    stages = json.loads(_read(golden_runs['torch_exact'] + '.timings.json'))
    assert 'align_emit' in stages['timings_s']


def test_timings_written(golden_runs):
    import json
    stages = json.loads(_read(golden_runs['torch'] + '.timings.json'))
    assert {'filter_junk', 'find_primers', 'load_index', 'align',
            'bam_write', 'mapping_table'} <= set(stages['timings_s'])


@pytest.mark.parametrize('kw', [
    dict(skip_alignment=True), dict(n_processes=2)],
    ids=['skip_alignment', 'n_processes'])
def test_settings_outside_the_slice_raise(tmp_path, kw):
    config = PipelineConfig(name='X', out=str(tmp_path / 'out'),
                            skip_clustering=True, exact_cigars=False)
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        run_pipeline(config.replace(**kw), CPU)
    assert not os.path.exists(config.out)


def test_device_must_be_explicit(tmp_path):
    config = PipelineConfig(name='X', out=str(tmp_path / 'out'),
                            skip_clustering=True, exact_cigars=False)
    with pytest.raises(TypeError):
        run_pipeline(config, 'cpu')

