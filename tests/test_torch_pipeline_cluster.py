"""The port's default run (clustering) and its run_consensus=True run on
the CPU: the golden scenario of tests/test_golden_snapshot.py through
fslr_tpu_torch.pipeline and fslr_tpu.pipeline (backend='jax'), each
package with its own PipelineConfig from the same keywords.  Cluster and
representative beds, per-cluster FASTAs, consensus FASTA, purity CSV and
mappings_merged.bed are byte-equal; BAM records equal."""

import glob
import gzip
import os

import pytest
import torch

from fslr_tpu.config import ClusterConfig as JaxClusterConfig
from fslr_tpu.config import PipelineConfig as JaxPipelineConfig
from fslr_tpu.pipeline import run_pipeline as jax_run_pipeline
from fslr_tpu_torch.config import ClusterConfig, PipelineConfig
from fslr_tpu_torch.pipeline import run_pipeline
from tests.test_golden_snapshot import _build
from tests.test_torch_pipeline import ARTIFACTS, _bam_records, _read

CPU = torch.device('cpu')
CLUSTER_ARTIFACTS = ('.mappings.cluster.bed', '.mappings.representative.bed')


@pytest.fixture(scope='module')
def golden_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('golden'))
    ref, fq = _build(root)
    bases = {}
    # tag -> keywords, given the package's ClusterConfig
    for tag, kw in (
            ('cluster', lambda _: {}),
            ('consensus', lambda _: dict(run_consensus=True)),
            ('device_cluster', lambda ccls: dict(
                exact_cigars=False,
                cluster=ccls(device_enum_min_encounters=1)))):
        for pkg, cls, ccls in (('jax', JaxPipelineConfig, JaxClusterConfig),
                               ('torch', PipelineConfig, ClusterConfig)):
            config = cls(name='G', out=os.path.join(root, f'{pkg}_{tag}'),
                         ref=ref, primers=('21q1', '17p6'), basecalled=fq,
                         **kw(ccls))
            if pkg == 'jax':
                jax_run_pipeline(config, backend='jax')
            else:
                run_pipeline(config, CPU)
            bases[f'{pkg}_{tag}'] = os.path.join(config.out, 'G')
    return bases


@pytest.mark.parametrize('suffix', ARTIFACTS + CLUSTER_ARTIFACTS)
def test_default_run_byte_equal_to_fslr_tpu(golden_runs, suffix):
    """The default run (clustering on): cluster and representative beds
    and the earlier artifacts byte-equal."""
    got = _read(golden_runs['torch_cluster'] + suffix)
    assert got == _read(golden_runs['jax_cluster'] + suffix)
    if suffix in CLUSTER_ARTIFACTS:
        assert got.count(b'\n') > 1


@pytest.mark.parametrize('suffix', CLUSTER_ARTIFACTS)
def test_device_enumeration_run_byte_equal_to_fslr_tpu(golden_runs, suffix):
    """run_pipeline with device_enum_min_encounters=1 (the scale path of
    clustering; approximate CIGARs, the quicker align on the CPU): cluster
    and representative beds byte-equal to fslr_tpu's run with the same
    settings."""
    got = _read(golden_runs['torch_device_cluster'] + suffix)
    assert got == _read(golden_runs['jax_device_cluster'] + suffix)
    assert got.count(b'\n') > 1


def test_default_run_bam_records_equal_to_fslr_tpu(golden_runs):
    assert _bam_records(golden_runs['torch_cluster']) == \
        _bam_records(golden_runs['jax_cluster'])


def _consensus_files(base):
    """Every consensus-stage file under {out}/cluster (the re-filter's
    uuid-named no_primers files excluded) plus the merged bed."""
    out = os.path.dirname(base)
    files = sorted(os.path.relpath(p, out) for p in glob.glob(
        os.path.join(out, 'cluster', '**', '*'), recursive=True)
        if os.path.isfile(p) and not p.endswith('.no_primers.fq'))
    return files + [os.path.basename(base) + '.mappings_merged.bed']


def test_consensus_files_byte_equal_to_fslr_tpu(golden_runs):
    """Per-cluster FASTAs, consensus FASTA, purity CSV and
    mappings_merged.bed byte-equal."""
    jbase, tbase = golden_runs['jax_consensus'], golden_runs['torch_consensus']
    names = _consensus_files(tbase)
    assert names == _consensus_files(jbase)
    assert 'cluster/G.cluster.consensus.fa' in names
    assert 'cluster/G.cluster.purity.csv' in names
    for rel in names:
        assert _read(os.path.join(os.path.dirname(tbase), rel)) == \
            _read(os.path.join(os.path.dirname(jbase), rel)), rel


@pytest.mark.parametrize('bam', ['.bwa_dodi_merged.bam', '.bwa_dodi.bam'])
def test_consensus_bam_records_equal_to_fslr_tpu(golden_runs, bam):
    got = gzip.decompress(_read(golden_runs['torch_consensus'] + bam))
    assert got == gzip.decompress(_read(golden_runs['jax_consensus'] + bam))


def test_consensus_timings_have_the_new_stages(golden_runs):
    import json
    stages = json.loads(_read(golden_runs['torch_consensus']
                              + '.timings.json'))['timings_s']
    assert {'read_mappings', 'clustering', 'write_cluster_beds',
            'consensus'} <= set(stages)


def test_no_clusters_found(tmp_path, capsys):
    """With every interior interval masked the graph has no edges: the
    run stops after mappings.bed, as fslr_tpu's, and writes no cluster
    beds and no consensus."""
    from fslr_tpu_torch.config import ClusterConfig
    ref, fq = _build(str(tmp_path))
    config = PipelineConfig(name='G', out=str(tmp_path / 'out'), ref=ref,
                            primers=('21q1', '17p6'), basecalled=fq,
                            exact_cigars=False, run_consensus=True,
                            cluster=ClusterConfig(cluster_mask=('chrA',
                                                                'chrB')))
    run_pipeline(config, CPU)
    assert 'No clusters were found.' in capsys.readouterr().out
    base = os.path.join(config.out, 'G')
    assert os.path.exists(base + '.mappings.bed')
    assert not os.path.exists(base + '.mappings.cluster.bed')
    assert not os.path.exists(os.path.join(config.out, 'cluster'))


# the steps each clustering stage times as spans (instrument.span)
STEPS = {'read_mappings': ('parse', 'typing', 'header'),
         'clustering': ('prepare', 'tables', 'enum_merge', 'gate_order',
                        'value_replay', 'emit', 'components', 'assign',
                        'representatives'),
         'write_cluster_beds': ('format', 'write')}


@pytest.mark.parametrize('tag', ['torch_cluster', 'torch_device_cluster'])
def test_runs_time_every_clustering_step(golden_runs, tag):
    """The host path's run and the device enumeration's write every step
    of the three stages with positive seconds, within their stage's; the
    query_graph note keeps sizes, no seconds."""
    import json
    timings = json.loads(_read(golden_runs[tag] + '.timings.json'))
    secs = timings['timings_s']
    for stage, steps in STEPS.items():
        names = [f'{stage}.{s}' for s in steps]
        assert all(secs.get(n, 0) > 0 for n in names), stage
        assert sum(secs[n] for n in names) <= secs[stage]
    note = timings['query_graph']
    assert note['path'] == ('host' if tag == 'torch_cluster' else 'in-HBM')
    assert not [k for k in note if k.endswith('_s')]


@pytest.mark.parametrize('tag', ['torch_cluster', 'torch_device_cluster'])
def test_runs_note_how_read_mappings_typed_the_bed(golden_runs, tag):
    """The read_mappings note of timings.json: every column of the golden
    mappings.bed typed by the host runtime, none by _parse_column, and
    the file not read whole by the csv module."""
    import json
    timings = json.loads(_read(golden_runs[tag] + '.timings.json'))
    with open(golden_runs[tag] + '.mappings.bed') as fh:
        columns = len(fh.readline().split('\t'))
    assert timings['read_mappings'] == {'native_columns': columns,
                                        'python_columns': 0,
                                        'python_file': 0}
