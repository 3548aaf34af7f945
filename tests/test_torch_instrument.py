"""The port's span recorder (``fslr_tpu_torch.instrument``) on the CPU.

* ``span`` names a step ``<innermost open span>.<step>`` and does nothing
  where no timer is active;
* seconds come from ``time.perf_counter``; a span never waits for the
  device;
* a span on the timer's thread is a ``torch.profiler`` range of its
  name, one on another thread records seconds only;
* under ``torch.profiler`` the ranges of a ``skip_alignment`` run sum,
  name by name, to its ``timings_s`` seconds;
* ``report`` prints steps under their stage, with shares of the
  top-level spans only.

The steps of the golden runs: tests/test_torch_pipeline_cluster.py.
"""

import json
import os
import threading
import time

import pytest
import torch

from fslr_tpu_torch import instrument
from fslr_tpu_torch.instrument import StageTimer, activate, span
from fslr_tpu_torch.pipeline import run_pipeline
from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.tools.profile_run import _events
from tests.test_golden_snapshot import _build

CPU = torch.device('cpu')


def _ranges(prof) -> dict:
    """{name: [host range seconds, ...]} of a stopped profiler."""
    out: dict = {}
    for name, a, b, on_device in _events(prof):
        if not on_device:
            out.setdefault(name, []).append((b - a) / 1e6)
    return out


def test_span_names_nest_under_the_open_span():
    timer = StageTimer()
    with activate(timer):
        with span('top'):
            with span('step'):
                with span('inner'):
                    pass
            with timer.stage('literal'):
                with span('step'):
                    pass
        with timer.stage('stage'):
            with span('step'):
                pass
            with span('step'):
                pass
    assert set(timer.timings) == {'top', 'top.step', 'top.step.inner',
                                  'literal', 'literal.step', 'stage',
                                  'stage.step'}
    assert timer.counts['stage.step'] == 2
    assert timer.parents['top.step.inner'] == 'top.step'
    assert timer.parents['literal'] == 'top'
    assert timer.parents['stage'] is None


def test_span_without_an_active_timer_does_nothing():
    timer = StageTimer()
    with activate(timer):
        pass
    assert instrument._active is None
    with span('step'):
        pass
    assert timer.timings == {}
    # the previous timer comes back when an inner one ends
    outer, inner = StageTimer(), StageTimer()
    with activate(outer):
        with activate(inner):
            with span('a'):
                pass
        with span('b'):
            pass
    assert set(inner.timings) == {'a'} and set(outer.timings) == {'b'}


def test_seconds_come_from_perf_counter(monkeypatch):
    ticks = iter([10.0, 10.25, 20.0, 20.5])
    monkeypatch.setattr(instrument.time, 'perf_counter',
                        lambda: next(ticks))

    def wall():
        raise AssertionError('a span read the wall clock')
    monkeypatch.setattr(instrument.time, 'time', wall)
    timer = StageTimer()
    with timer.stage('a'):
        pass
    with activate(timer), span('a'):
        pass
    assert timer.timings == {'a': 0.75}
    assert timer.counts == {'a': 2}


def test_add_records_seconds_timed_elsewhere():
    timer = StageTimer()
    timer.add('bam_records', 0.5)
    timer.add('bam_records', 0.25)
    assert timer.timings == {'bam_records': 0.75}
    assert timer.counts == {'bam_records': 2}


def test_span_on_another_thread_records_seconds_but_no_range():
    timer = StageTimer()

    def other():
        with timer.stage('index_build'):
            with span('step'):
                torch.ones(100).cumsum(0)

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with activate(timer):
            with timer.stage('main'):
                with span('step'):
                    torch.ones(100).cumsum(0)
            th = threading.Thread(target=other)
            th.start()
            th.join(timeout=60)
    assert not th.is_alive()
    assert set(timer.timings) == {'main', 'main.step', 'index_build',
                                  'index_build.step'}
    ranges = _ranges(prof)
    assert {'main', 'main.step'} <= set(ranges)
    assert 'index_build' not in ranges and 'index_build.step' not in ranges


def test_span_never_synchronises_the_device(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, 'synchronize',
                        lambda *a, **k: calls.append(a))
    timer = StageTimer(CPU)
    with activate(timer), timer.stage('stage'), span('step'):
        torch.ones(10).sum()
    assert calls == []
    assert set(timer.timings) == {'stage', 'stage.step'}


def test_report_indents_steps_and_shares_top_level(capsys, tmp_path):
    timer = StageTimer()
    with activate(timer):
        with timer.stage('clustering'):
            with span('tables'):
                pass
    timer.add('read_mappings', 0.0)
    timer.timings.update({'clustering': 3.0, 'clustering.tables': 2.0,
                          'read_mappings': 1.0})
    timer.report(str(tmp_path / 't.json'))
    lines = capsys.readouterr().err.splitlines()
    assert lines[0] == 'stage timings:'
    clustering = next(ln for ln in lines if ln.split()[0] == 'clustering')
    tables = next(ln for ln in lines
                  if ln.split()[0] == 'clustering.tables')
    # shares of the top-level spans' 4 s, the step indented under its
    # stage and without a share
    assert '75.0%' in clustering and '%' not in tables
    assert lines.index(tables) == lines.index(clustering) + 1
    assert len(tables) - len(tables.lstrip()) == \
        len(clustering) - len(clustering.lstrip()) + 2
    with open(tmp_path / 't.json') as fh:
        assert json.load(fh)['timings_s']['clustering.tables'] == 2.0


@pytest.fixture(scope='module')
def earlier_run(tmp_path_factory):
    """A run's mappings.bed and BAM, which skip_alignment clusters."""
    root = str(tmp_path_factory.mktemp('instrument'))
    ref, fq = _build(root)
    config = PipelineConfig(name='G', out=os.path.join(root, 'out'),
                            ref=ref, primers=('21q1', '17p6'),
                            basecalled=fq, exact_cigars=False)
    run_pipeline(config, CPU)
    return config


def test_ranges_sum_to_the_recorded_seconds(earlier_run):
    """Every span of a skip_alignment run is a profiler range of its
    name, as often as it ran, and each name's ranges sum to its
    timings_s seconds.  Here a span takes 0.03-2 ms, so beside the 1% the
    sums may differ by what the profiler itself spends entering and
    leaving a range, outside the span's clock (15-45 us a call on this
    run), allowed as 100 us a call."""
    config = earlier_run.replace(skip_alignment=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run_pipeline(config, CPU)
    with open(os.path.join(config.out, 'G.timings.json')) as fh:
        t = json.load(fh)
    ranges = _ranges(prof)
    assert {'read_mappings.parse', 'read_mappings.typing',
            'read_mappings.header', 'clustering.prepare',
            'write_cluster_beds.format'} <= set(t['timings_s'])
    for name, secs in t['timings_s'].items():
        assert len(ranges.get(name, ())) == t['counts'][name], name
        assert sum(ranges[name]) == pytest.approx(
            secs, rel=0.01, abs=1e-4 * t['counts'][name]), name


def test_ranges_of_long_spans_within_one_percent():
    """Spans of ~20 ms: each name's ranges sum to its seconds within
    1%."""
    timer = StageTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with activate(timer), timer.stage('stage'):
            for step in ('a', 'b', 'a'):
                with span(step):
                    time.sleep(0.02)
    ranges = _ranges(prof)
    assert set(timer.timings) == {'stage', 'stage.a', 'stage.b'}
    for name, secs in timer.timings.items():
        assert len(ranges[name]) == timer.counts[name]
        assert sum(ranges[name]) == pytest.approx(secs, rel=0.01), name
