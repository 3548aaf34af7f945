"""Gzipped input end to end on the CPU: make_dataset's reads as a folder
of two-member ``.fq.gz`` files with text after the last member
(tools.synth.gzip_folder), which zlib's gzread in fslr_tpu's reader reads
and Python's gzip module refuses, through fslr_tpu's run_pipeline
(backend='jax') and the port's, the default run with clustering.  Beds,
filter counts and the primer stage's FASTQ byte-equal, BAM records equal,
and all of them equal to the port's run on the plain folder."""

import os

import pytest
import torch

from fslr_tpu.config import PipelineConfig as JaxPipelineConfig
from fslr_tpu.pipeline import run_pipeline as jax_run_pipeline
from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.pipeline import run_pipeline
from fslr_tpu_torch.tools.synth import GZIP_TAIL, gzip_folder, make_dataset
from tests.test_torch_pipeline import ARTIFACTS, _bam_records, _read
from tests.test_torch_pipeline_cluster import CLUSTER_ARTIFACTS

N_READS, N_GROUPS = 40, 4


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('gzip_input'))
    ref, fq = make_dataset(root, N_READS, N_GROUPS)
    gz = gzip_folder(fq, os.path.join(root, 'reads_gz'))
    bases = {}
    for tag, cls, folder in (('jax', JaxPipelineConfig, gz),
                             ('torch', PipelineConfig, gz),
                             ('torch_plain', PipelineConfig, fq)):
        config = cls(name='G', out=os.path.join(root, tag), ref=ref,
                     primers=('21q1', '17p6'), basecalled=folder)
        if tag == 'jax':
            jax_run_pipeline(config, backend='jax')
        else:
            run_pipeline(config, torch.device('cpu'))
        bases[tag] = os.path.join(config.out, 'G')
    return gz, bases


def test_input_is_gzip_with_text_after_it(runs):
    gz, _ = runs
    assert os.listdir(gz) == ['b0.fq.gz']
    data = _read(os.path.join(gz, 'b0.fq.gz'))
    assert data[:2] == b'\x1f\x8b' and data.endswith(GZIP_TAIL)
    # two members: the magic again after the first
    assert data.count(b'\x1f\x8b\x08') >= 2


@pytest.mark.parametrize('suffix', ARTIFACTS + CLUSTER_ARTIFACTS)
@pytest.mark.parametrize('against', ['jax', 'torch_plain'])
def test_artifacts_byte_equal(runs, against, suffix):
    _, bases = runs
    got = _read(bases['torch'] + suffix)
    assert got == _read(bases[against] + suffix)
    if suffix == '.filter_counts_summary.csv':
        assert f',{N_READS},'.encode() in got
    if suffix in CLUSTER_ARTIFACTS:
        assert got.count(b'\n') > 1


@pytest.mark.parametrize('against', ['jax', 'torch_plain'])
def test_bam_records_equal(runs, against):
    _, bases = runs
    got = _bam_records(bases['torch'])
    assert got == _bam_records(bases[against])
    assert got.startswith(b'BAM\x01')
