"""The port's DP-cell counters and profiler hook on the CPU.

* After the same run, ``fslr_tpu_torch.instrument.cell_counts()`` equals
  ``fslr_tpu.instrument.cell_counts()`` tag by tag: the default pipeline
  with the consensus stage on ``tools.synth.make_dataset(root, 60, 3)``
  (every tag but 'jaccard', which its single-interval reads value in
  closed form), query_graph's scale path (capwalk.resolve_device,
  'jaccard') with ``device_enum_min_encounters=1`` on both sides, and
  query_graph's host path on reads of two intervals each (their pairs
  valued by ops/jaccard.jaccard_pairs_indexed, 'jaccard').
* ``tools.synth.make_dataset`` writes ``bench.make_dataset``'s bytes.
* Each mode of ``python -m fslr_tpu_torch.bench`` prints the keys that
  ``bench.py``'s main prints in that mode (and 'device'), both mains run
  here with the pipeline run stubbed; chip_smoke.py's BENCH_KEYS, which
  the tests of the modes' real runs and the card's phase 13 hold the
  lines to, are bench.py's.
* With ``FSLR_PROFILE_DIR`` set a pipeline run writes one Chrome trace
  and the trace's reading to its timings.json; unset, neither.

The bench's modes: tests/test_torch_bench_modes.py.
"""

import contextlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import bench as jbench
from fslr_tpu import instrument as jinstrument
from fslr_tpu.config import ClusterConfig as JaxClusterConfig
from fslr_tpu.config import PipelineConfig as JaxPipelineConfig
from fslr_tpu.pipeline import run_pipeline as jax_run_pipeline
from fslr_tpu.stages import cluster as jcluster
from chip_smoke import BENCH_KEYS
from fslr_tpu_torch import bench, instrument
from fslr_tpu_torch.config import ClusterConfig, PipelineConfig
from fslr_tpu_torch.pipeline import run_pipeline
from fslr_tpu_torch.stages import cluster as tcluster
from fslr_tpu_torch.tools import synth
from fslr_tpu_torch.tools.profile_run import read_profile

CPU = torch.device('cpu')
TAGS = {'seed', 'extend', 'select', 'jaccard', 'profile', 'hmm',
        'sw_concat', 'sw_primer'}


def _two_intervals(data):
    """Each read of ``data`` given a second interval 2 Mbp on."""
    n = len(data)
    return sorted(data + [it._replace(start=it.start + 2_000_000,
                                      end=it.end + 2_000_000,
                                      middle=it.middle + 2_000_000,
                                      index=it.index + n) for it in data],
                  key=lambda it: it.start)


def _query_graph(module, data, cfg, *device):
    return module.query_graph(data, cfg.overlap, list(cfg.jaccard_cutoffs),
                              cfg.edge_threshold, cfg.qlen_diff,
                              cfg.n_alignment_diff, cfg, *device)


@pytest.fixture(scope='module')
def counted(tmp_path_factory):
    """{case: (fslr_tpu's cell_counts(), the port's)} after each run."""
    root = str(tmp_path_factory.mktemp('cells'))
    ref, fq = synth.make_dataset(root, 60, 3)
    kw = dict(name='B', ref=ref, primers=('21q1', '17p6'), basecalled=fq,
              run_consensus=True)
    out = {}
    jinstrument.reset_cells()
    jax_run_pipeline(JaxPipelineConfig(out=os.path.join(root, 'jax'), **kw),
                     backend='jax')
    instrument.reset_cells()
    run_pipeline(PipelineConfig(out=os.path.join(root, 'torch'), **kw), CPU)
    out['pipeline'] = (jinstrument.cell_counts(), instrument.cell_counts())
    data = synth.make_cluster_scale_data(400, 100)
    jinstrument.reset_cells()
    _query_graph(jcluster, data, JaxClusterConfig(
        device_enum_min_encounters=1, exact_cap_replay=False))
    instrument.reset_cells()
    _query_graph(tcluster, data, ClusterConfig(
        device_enum_min_encounters=1, exact_cap_replay=False), CPU)
    out['query_graph'] = (jinstrument.cell_counts(), instrument.cell_counts())
    data = _two_intervals(data)
    jinstrument.reset_cells()
    _query_graph(jcluster, data, JaxClusterConfig(exact_cap_replay=False))
    instrument.reset_cells()
    _query_graph(tcluster, data, ClusterConfig(exact_cap_replay=False), CPU)
    out['two_intervals'] = (jinstrument.cell_counts(),
                            instrument.cell_counts())
    return out


@pytest.mark.parametrize('case', ['pipeline', 'query_graph',
                                  'two_intervals'])
def test_cell_counts_equal_fslr_tpu(counted, case):
    want, got = counted[case]
    for tag in sorted(set(want) | set(got)):
        assert got.get(tag) == want.get(tag), tag
    assert got == want
    if case == 'two_intervals':
        # the host path's only 'jaccard' site is jaccard_pairs_indexed
        assert set(got) == {'jaccard'} and got['jaccard'] > 0


def test_cell_counts_reach_every_tag(counted):
    seen = set(counted['pipeline'][1]) | set(counted['query_graph'][1])
    assert seen == TAGS
    assert all(v > 0 for c in counted.values() for v in c[1].values())


@pytest.mark.parametrize('n_reads,n_groups', [(40, 20), (60, 3), (30, 1428)])
def test_make_dataset_writes_the_bench_bytes(tmp_path, n_reads, n_groups):
    got, want = tmp_path / 'port', tmp_path / 'bench'
    got.mkdir()
    want.mkdir()
    paths = (synth.make_dataset(str(got), n_reads, n_groups),
             jbench.make_dataset(str(want), n_reads, n_groups))
    for a, b in zip(*paths):
        if os.path.isdir(a):
            a, b = (os.path.join(p, 'b0.fastq') for p in (a, b))
        with open(a, 'rb') as fa, open(b, 'rb') as fb:
            assert fa.read() == fb.read()


# (bench.py's argv, the port's) of each mode; the port's runs on the CPU
MODES = {
    'default': ([], ['--device', 'cpu']),
    'default --skip-10k': (['--skip-10k'], ['--skip-10k', '--device', 'cpu']),
    'consensus': (['--consensus', '--reads', '60'],
                  ['--consensus', '--reads', '60', '--device', 'cpu']),
    'scale': (['--scale', '60', '--groups', '3'],
              ['--scale', '60', '--groups', '3', '--device', 'cpu']),
    'cluster-scale': (['--cluster-scale', '1400'],
                      ['--cluster-scale', '1400', '--device', 'cpu']),
    'cpu-baseline': (['--cpu-baseline'], ['--cpu-baseline']),
}


def _keys(main, capsys) -> set:
    with contextlib.redirect_stderr(open(os.devnull, 'w')):
        main()
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    return set(json.loads(out[0]))


@pytest.mark.parametrize('mode', list(MODES))
def test_bench_keys_are_bench_pys(mode, tmp_path, monkeypatch, capsys):
    """bench.py's main and the port's in ``mode``, the pipeline run
    stubbed on both sides (the keys come from the mains, measure and
    run_scale; clustering at 1,400 reads runs for real): the port prints
    bench.py's keys and 'device' (--cpu-baseline: bench.py's keys)."""
    jargv, targv = MODES[mode]

    def run_once(*args, **kw):
        return 1.0, {'align': 1.0, 'consensus': 1.0}, {'extend': 1,
                                                       'profile': 1}
    for mod in (jbench, bench):
        monkeypatch.setattr(mod, 'run_once', run_once)
        monkeypatch.setattr(mod, 'make_dataset', lambda *a, **kw: (0, 0))
    # both mains' run folders and baseline caches in tmp_path
    mkdtemp = jbench.tempfile.mkdtemp
    monkeypatch.setattr(jbench.tempfile, 'mkdtemp',
                        lambda suffix=None, prefix=None, dir=None:
                        mkdtemp(suffix, prefix, str(tmp_path)))
    monkeypatch.setattr(jbench, '__file__', str(tmp_path / 'bench.py'))
    (tmp_path / '.bench_baseline.json').write_text('{"cpu_reads_per_s": 1}')
    monkeypatch.setattr(bench, 'BASELINE_CACHE', str(tmp_path / 'b.json'))
    (tmp_path / 'b.json').write_text('{"cpu_reads_per_s": 1}')
    monkeypatch.setattr(sys, 'argv', ['bench.py', *jargv])
    want = _keys(jbench.main, capsys)
    got = _keys(lambda: bench.main(targv), capsys)
    # --cpu-baseline's line is the default mode's input, no result
    assert got == want | ({'device'} if mode != 'cpu-baseline' else set())
    name = mode.split()[0]
    if name in BENCH_KEYS and mode == name:
        assert BENCH_KEYS[name] == want


@pytest.fixture(scope='module')
def masked_run(tmp_path_factory):
    """A run of the masked scenario's six reads without FSLR_PROFILE_DIR
    (its root and config); the profiled test clusters its outputs."""
    root = str(tmp_path_factory.mktemp('profile'))
    ref, fq, _, _ = synth.make_masked_dataset(root)
    config = PipelineConfig(name='P', out=os.path.join(root, 'out'),
                            ref=ref, primers=('21q1', '17p6'),
                            basecalled=fq)
    env = os.environ.pop('FSLR_PROFILE_DIR', None)
    try:
        run_pipeline(config, CPU)
    finally:
        if env is not None:
            os.environ['FSLR_PROFILE_DIR'] = env
    return root, config


def _traces(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if f.endswith('.pt.trace.json')]


def test_no_profile_dir_writes_no_trace(masked_run):
    root, config = masked_run
    with open(os.path.join(config.out, 'P.timings.json')) as fh:
        timings = json.load(fh)
    assert 'profile' not in timings
    assert _traces(root) == []
    # clustering's own note; the peak device memory is a card's only
    assert timings['query_graph'] == {'path': 'host'}
    assert 'device_peak_bytes' not in timings


def test_profile_dir_gets_one_trace(masked_run, tmp_path, monkeypatch):
    """The clustering run over the earlier run's artifacts
    (skip_alignment), traced on the CPU: one Chrome trace in the folder,
    its reading in timings.json."""
    root, config = masked_run
    trace_dir = tmp_path / 'trace'
    monkeypatch.setenv('FSLR_PROFILE_DIR', str(trace_dir))
    run_pipeline(config.replace(skip_alignment=True), CPU)
    assert _traces(str(tmp_path)) == [str(trace_dir / 'P.pt.trace.json')]
    with open(trace_dir / 'P.pt.trace.json') as fh:
        assert json.load(fh)['traceEvents']
    with open(os.path.join(config.out, 'P.timings.json')) as fh:
        profile = json.load(fh)['profile']
    assert profile['trace'] == str(trace_dir / 'P.pt.trace.json')
    assert 'read_mappings' in profile['stages']
    assert profile['device_events'] == 0
    assert np.isfinite(profile['wall_s'])


def test_profiled_run_that_fails_shows_its_own_error(masked_run, tmp_path,
                                                     monkeypatch):
    """A traced run that raises: its own error propagates, the profiler
    stops and no trace is written."""
    _, config = masked_run
    monkeypatch.setenv('FSLR_PROFILE_DIR', str(tmp_path / 'trace'))
    missing = str(tmp_path / 'missing.fa')
    with pytest.raises(FileNotFoundError, match='missing.fa'):
        run_pipeline(config.replace(ref=missing,
                                    out=str(tmp_path / 'out')), CPU)
    assert _traces(str(tmp_path)) == []
    assert not torch.autograd.profiler._is_profiler_enabled


def test_profile_reading_without_raw_events():
    """read_profile over the public events() (a torch without the raw
    events) reads what it reads over the raw ones."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for name in ('a', 'b', 'a'):
            with torch.profiler.record_function(name):
                torch.ones(1000).cumsum(0)

    class Public:
        events = prof.events
    raw, public = read_profile(prof, {'a', 'b'}), read_profile(Public, {'a',
                                                                      'b'})
    assert raw['stages'].keys() == public['stages'].keys() == {'a', 'b'}
    for k in 'ab':
        assert public['stages'][k]['wall_ms'] == pytest.approx(
            raw['stages'][k]['wall_ms'], abs=0.01)
    assert raw['device_events'] == public['device_events'] == 0
