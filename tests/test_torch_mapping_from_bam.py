"""The standalone BAM -> mappings.bed mode of the port
(fslr_tpu_torch/stages/mapping_table.py: mapping_table_from_bam, _main)
against fslr_tpu's: every bed byte-equal to fslr_tpu's
write_mappings_bed(mapping_table_from_bam(...)), on the golden scenario's
BAMs (the port's pipeline with exact CIGARs and without) and on
tests/test_mapping_oracle.py's random BAMs (several primaries per read,
secondary and supplementary records, hard clips, inferred-primer reads),
with and without --regions; both packages raise ValueError on a read
with only secondary and supplementary records; and the module entry
point writes fslr_tpu's file."""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

from fslr_tpu.stages import mapping_table as jmt
from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.io import bam as bamio
from fslr_tpu_torch.pipeline import run_pipeline
from fslr_tpu_torch.stages import mapping_table as tmt
from tests.test_golden_snapshot import _build
from tests.test_mapping_oracle import PRIMERS, make_bam

GOLDEN_REGIONS = 'chrA\t100000\t100500\nchrB\t200500\t201200\n'
RANDOM_REGIONS = 'chr1\t100000\t2000000\nchr2\t0\t500000\n'


def _read(path):
    with open(path, 'rb') as fh:
        return fh.read()


def _beds(tmp_path, bam, regions, primers):
    """(port's bed, fslr_tpu's bed) of ``bam`` as bytes."""
    out = {}
    for tag, mod in (('torch', tmt), ('jax', jmt)):
        path = str(tmp_path / f'{tag}.bed')
        mod.write_mappings_bed(mod.mapping_table_from_bam(bam, regions,
                                                          primers), path)
        out[tag] = _read(path)
    return out['torch'], out['jax']


def _regions(tmp_path, text):
    path = str(tmp_path / 'regions.bed')
    with open(path, 'w') as fh:
        fh.write(text)
    return path


@pytest.fixture(scope='module')
def golden_bams(tmp_path_factory):
    """The port's pipeline on the golden scenario, with exact CIGARs and
    without: {exact: BAM path}."""
    root = str(tmp_path_factory.mktemp('golden_bam'))
    ref, fq = _build(root)
    bams = {}
    for exact in (True, False):
        out = os.path.join(root, f'out_{exact}')
        run_pipeline(PipelineConfig(name='G', out=out, ref=ref,
                                    primers=('21q1', '17p6'), basecalled=fq,
                                    skip_clustering=True,
                                    exact_cigars=exact), torch.device('cpu'))
        bams[exact] = os.path.join(out, 'G.bwa_dodi.bam')
    return bams


@pytest.mark.parametrize('regions', [False, True])
@pytest.mark.parametrize('exact', [True, False])
def test_golden_bam(golden_bams, tmp_path, exact, regions):
    path = _regions(tmp_path, GOLDEN_REGIONS) if regions else None
    got, want = _beds(tmp_path, golden_bams[exact], path, None)
    assert got == want
    assert got.count(b'\n') > 7
    if regions:
        assert got.splitlines()[0].endswith(b'\toverlaps_region')


@pytest.mark.parametrize('regions', [False, True])
@pytest.mark.parametrize('seed', range(4))
def test_random_bam(tmp_path, seed, regions):
    bam = make_bam(str(tmp_path / 'x.bam'),
                   np.random.default_rng(3000 + seed))
    path = _regions(tmp_path, RANDOM_REGIONS) if regions else None
    got, want = _beds(tmp_path, bam, path, PRIMERS)
    assert got == want
    assert got.count(b'\n') > 40


def test_secondary_only_read_raises(tmp_path):
    rec = dict(ref_id=0, pos=100, mapq=60, cigar=[(50, 'M')], seq='A' * 50,
               qual=None, tags={'AS': 50})
    bam = str(tmp_path / 's.bam')
    bamio.write_bam(bam, ['chr1'], [10_000], [
        bamio.BamRecord(qname='a', flag=0, **rec),
        bamio.BamRecord(qname='b', flag=256, **rec),
        bamio.BamRecord(qname='b', flag=2048, **rec)])
    messages = []
    for mod in (tmt, jmt):
        with pytest.raises(ValueError, match='no primary-eligible') as err:
            mod.mapping_table_from_bam(bam, None, PRIMERS)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# runpy warns that the package's import already loaded the module
@pytest.mark.filterwarnings('ignore:.*found in sys.modules:RuntimeWarning')
def test_module_entry_point(golden_bams, tmp_path, monkeypatch, capsys):
    """``python -m fslr_tpu_torch.stages.mapping_table BAM OUT --regions``
    (run as ``-m`` runs it, through runpy) writes the file
    ``fslr_tpu.stages.mapping_table._main`` writes."""
    regions = _regions(tmp_path, GOLDEN_REGIONS)
    got = str(tmp_path / 'torch.bed')
    monkeypatch.setattr(sys, 'argv', [
        'mapping_table', golden_bams[True], got, '--regions', regions])
    runpy.run_module('fslr_tpu_torch.stages.mapping_table',
                     run_name='__main__', alter_sys=True)
    assert capsys.readouterr().out.strip() == 'Done'
    want = str(tmp_path / 'jax.bed')
    jmt._main([golden_bams[True], want, '--regions', regions])
    assert _read(got) == _read(want)
