"""The clustering layer's step metrics (``benchmark/metrics/
cluster_io.*_ms_per_kread.py`` and ``clustering.*_ms_per_kread.py`` of
the steps) on hand-made records: each sums its step spans over the
window's samples, per 1,000 input reads, and reads nothing where the
program has no such spans."""

from types import SimpleNamespace

import pytest

from benchmark import run

# metric -> the spans it sums
STEPS = {
    'cluster_io.parse_ms_per_kread': ('read_mappings.parse',
                                      'read_mappings.header'),
    'cluster_io.typing_ms_per_kread': ('read_mappings.typing',),
    'cluster_io.format_ms_per_kread': ('write_cluster_beds.format',),
    'clustering.prepare_ms_per_kread': ('clustering.prepare',),
    'clustering.tables_ms_per_kread': ('clustering.tables',),
    'clustering.graph_ms_per_kread': ('clustering.enum_merge',
                                      'clustering.gate_order',
                                      'clustering.value_replay'),
    'clustering.emit_ms_per_kread': ('clustering.emit',),
    'clustering.assign_ms_per_kread': ('clustering.components',
                                       'clustering.assign',
                                       'clustering.representatives'),
}

# two samples' timings_s: every step of the three stages, each with
# its own seconds (a power of two, so that each sum is exact)
SPANS = sorted({s for spans in STEPS.values() for s in spans}
               | {'read_mappings', 'clustering', 'write_cluster_beds',
                  'write_cluster_beds.write'})
SAMPLE = {name: 2.0 ** -k for k, name in enumerate(SPANS)}


def _rec(timings, reads=4000):
    return SimpleNamespace(reads=reads, timings=timings)


@pytest.mark.parametrize('name', sorted(STEPS))
def test_step_metric_sums_its_spans(name):
    m = run.load_module('metrics', name)
    assert m.UNIT == 'ms/kread'
    rec = _rec([{'timings_s': dict(SAMPLE)},
                {'timings_s': {k: 3 * v for k, v in SAMPLE.items()}}])
    want = 4 * sum(SAMPLE[s] for s in STEPS[name])
    # ms per 1,000 reads: 4,000 reads
    assert m.read(rec) == pytest.approx(1e3 * want / 4)


@pytest.mark.parametrize('name', sorted(STEPS))
def test_step_metric_reads_nothing_without_its_spans(name):
    """A program without the step spans (the parent of the change that
    added them) writes only the stages: nothing to read, no error."""
    m = run.load_module('metrics', name)
    stages = {'read_mappings': 1.0, 'clustering': 2.0,
              'write_cluster_beds': 0.5}
    assert m.read(_rec([{'timings_s': stages}])) is None
    assert m.read(_rec([{'timings_s': dict(SAMPLE)}], reads=0)) is None


def test_steps_are_listed_for_the_cell():
    """Each step metric is a per-layer entry of BENCHMARK.json, of the
    clustering layer, read in the recluster cell, moving reads_per_s."""
    cell, _, _, _, layer = run.load_cell('tf2p_recluster.dup700_near')
    assert set(STEPS) <= set(layer)
    import json
    import os
    with open(os.path.join(run.ROOT, 'BENCHMARK.json')) as fh:
        per_layer = {m['name']: m for m in json.load(fh)['per_layer']}
    for name in STEPS:
        m = per_layer[name]
        assert (m['source'], m['layer'], m['moves'], m['workloads']) == (
            'program_span', 'clustering', 'reads_per_s', [cell['name']])
