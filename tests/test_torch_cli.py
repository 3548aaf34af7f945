"""fslr_tpu_torch.cli on the CPU: it builds the PipelineConfig that
fslr_tpu's click CLI builds from the same options and the mesh of
--mesh-devices, runs the golden scenario to the same artifacts as
run_pipeline, and refuses what the port cannot run before it writes
anything."""

import dataclasses
import gzip
import os

import pytest
import torch

from fslr_tpu_torch import cli
from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.parallel.mesh import Mesh
from fslr_tpu_torch.pipeline import run_pipeline
from tests.test_golden_snapshot import _build
from tests.test_torch_env import _card_defaults

ARTIFACTS = ('.mappings.bed', '.filter_counts_summary.csv',
             '.without_primers.fq', '.bwa_dodi.bam.bai')


def _read(path):
    with open(path, 'rb') as fh:
        return fh.read()


def _argv(out, ref, fq, *extra):
    return ['--name', 'G', '--out', out, '--ref', ref, '--primers',
            '21q1,17p6', '--basecalled', fq, *extra]


@pytest.fixture(scope='module')
def golden(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('cli'))
    ref, fq = _build(root)
    return root, ref, fq


def test_cli_run_equals_run_pipeline(golden):
    root, ref, fq = golden
    out_cli = os.path.join(root, 'cli')
    cli.main(_argv(out_cli, ref, fq, '--skip-clustering', '--device', 'cpu'))
    config = PipelineConfig(name='G', out=os.path.join(root, 'lib'),
                            ref=ref, primers=('21q1', '17p6'),
                            basecalled=fq, skip_clustering=True)
    run_pipeline(config, torch.device('cpu'))
    a, b = os.path.join(out_cli, 'G'), os.path.join(config.out, 'G')
    for suffix in ARTIFACTS:
        assert _read(a + suffix) == _read(b + suffix), suffix
    assert gzip.decompress(_read(a + '.bwa_dodi.bam')) == \
        gzip.decompress(_read(b + '.bwa_dodi.bam'))


@pytest.mark.parametrize('extra', [[], ['--consensus']],
                         ids=['default', 'consensus'])
def test_cli_clustering_run_equals_run_pipeline(golden, extra):
    """Without --skip-clustering the CLI clusters (and with --consensus
    builds consensus) as run_pipeline does."""
    root, ref, fq = golden
    tag = '_'.join(['c'] + [x.strip('-') for x in extra])
    out_cli = os.path.join(root, tag)
    cli.main(_argv(out_cli, ref, fq, '--device', 'cpu', *extra))
    config = cli.config_from_args(cli._parser().parse_args(
        _argv(os.path.join(root, tag + '_lib'), ref, fq, *extra)))
    run_pipeline(config, torch.device('cpu'))
    a, b = os.path.join(out_cli, 'G'), os.path.join(config.out, 'G')
    suffixes = ['.mappings.cluster.bed', '.mappings.representative.bed']
    if extra:
        suffixes.append('.mappings_merged.bed')
        assert _read(os.path.join(out_cli, 'cluster',
                                  'G.cluster.consensus.fa')) == \
            _read(os.path.join(config.out, 'cluster',
                               'G.cluster.consensus.fa'))
    for suffix in suffixes:
        assert _read(a + suffix) == _read(b + suffix), suffix


def test_cli_cuda_without_a_card_raises(golden, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    _, ref, fq = golden
    out = str(tmp_path / 'out')
    with pytest.raises(RuntimeError, match='no CUDA card'):
        cli.main(_argv(out, ref, fq, '--skip-clustering'))
    assert not os.path.exists(out)


def test_cli_rejects_a_missing_regions_file(golden, tmp_path):
    _, ref, fq = golden
    with pytest.raises(SystemExit):
        cli.main(_argv(str(tmp_path / 'out'), ref, fq, '--regions',
                       str(tmp_path / 'missing.bed'), '--device', 'cpu'))


@pytest.mark.parametrize('extra', [
    [],
    ['--skip-clustering', '--keep-temp', '--trim-threshold', '0.5',
     '--bias', '1.2', '--procs', '3', '--jaccard-cutoffs', '1,0.5',
     '--overlap', '0.7', '--n-alignment-diff', '0.3', '--qlen-diff', '0.1',
     '--cluster-mask', 'chr1,chr2', '--filter-high-coverage',
     '--filter-false', '--consensus', '--consensus-engine', 'pileup',
     '--n-processes', '2', '--process-id', '1', '--coordinator', 'h:1']],
    ids=['defaults', 'every_option'])
def test_config_equals_fslr_tpu_cli(golden, monkeypatch, extra):
    from click.testing import CliRunner

    import fslr_tpu.pipeline
    from fslr_tpu.cli import pipeline
    _, ref, fq = golden
    argv = _argv('out', ref, fq, *extra, '--mesh-devices', '1')
    seen = {}
    monkeypatch.setattr(fslr_tpu.pipeline, 'run_pipeline',
                        lambda config, mesh=None: seen.update(c=config))
    res = CliRunner().invoke(pipeline, argv)
    assert res.exit_code == 0, res.output
    got = cli.config_from_args(cli._parser().parse_args(argv))
    # fslr_tpu's settings, but for those the port sets for its card
    assert dataclasses.asdict(got) == _card_defaults(seen['c'])


@pytest.mark.parametrize('n,want', [('2', 2), ('1', None), ('0', None)])
def test_mesh_devices_on_the_cpu(golden, monkeypatch, n, want):
    """--mesh-devices n with --device cpu hands run_pipeline a mesh of n
    CPU entries; 1, and 0 (all visible devices: the CPU is one), none."""
    import fslr_tpu_torch.pipeline
    _, ref, fq = golden
    seen = {}
    monkeypatch.setattr(
        fslr_tpu_torch.pipeline, 'run_pipeline',
        lambda config, device, mesh=None: seen.update(d=device, m=mesh))
    cli.main(_argv('out', ref, fq, '--device', 'cpu', '--mesh-devices', n))
    assert seen['d'] == torch.device('cpu')
    assert seen['m'] == (Mesh((torch.device('cpu'),) * want) if want
                         else None)
