"""``python -m fslr_tpu_torch.bench``'s modes on the CPU at a tiny size
(``--device cpu``): each prints exactly one JSON line on stdout with
bench.py's keys (and 'device'); the default mode measures 40 reads
against a CPU baseline of 40 reads; the bench refuses to run without a
card when asked for one; the cluster-scale check raises on a tampered
edge set.  ``--consensus``: tests/test_torch_bench_consensus.py (a file of
its own, so that the two take separate test workers)."""

import json

import pytest
import torch

from chip_smoke import BENCH_KEYS
from fslr_tpu_torch import bench
from fslr_tpu_torch.config import ClusterConfig
from fslr_tpu_torch.stages import cluster
from fslr_tpu_torch.tools.synth import make_cluster_scale_data

CPU = torch.device('cpu')
# the keys of bench.py's JSON line in each mode, the 10k run's aside
KEYS = {mode: {k for k in keys if not k.endswith('_10k')}
        for mode, keys in BENCH_KEYS.items()}


def _line(capsys, mode=None) -> dict:
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    if mode:
        assert set(line) == KEYS[mode] | {'device'}
        assert line['device'] == 'host CPU'
        assert 'host CPU' in line['metric'] and 'TPU' not in line['metric']
        assert line['unit'] == 'reads/s' and line['value'] > 0
    return line


def test_default_mode_against_the_cpu_baseline(tmp_path, monkeypatch,
                                               capsys):
    """--cpu-baseline, then the default mode (--skip-10k) reading it from
    the cache, both at 40 reads."""
    monkeypatch.setattr(bench, 'N_READS', 40)
    monkeypatch.setattr(bench, 'N_READS_CPU', 40)
    cache = tmp_path / 'baseline.json'
    monkeypatch.setattr(bench, 'BASELINE_CACHE', str(cache))
    bench.main(['--cpu-baseline'])
    base = _line(capsys)
    assert set(base) == {'cpu_reads_per_s'} and base['cpu_reads_per_s'] > 0
    cache.write_text(json.dumps(base))
    bench.main(['--device', 'cpu', '--skip-10k'])
    line = _line(capsys, 'default')
    assert line['vs_baseline'] == round(line['value']
                                        / base['cpu_reads_per_s'], 2)
    assert len(line['wall_s_runs']) == 3
    assert {'filter_junk', 'find_primers', 'align'} <= set(
        line['stage_cells_per_s'])


def test_scale_mode(capsys):
    bench.main(['--scale', '60', '--groups', '3', '--device', 'cpu'])
    line = _line(capsys, 'scale')
    assert '60 synthetic fusion reads, 3 breakpoint groups' in line['metric']
    assert set(line['dp_cells']) == {'seed', 'extend', 'select', 'hmm',
                                     'sw_concat', 'sw_primer'}


def test_cluster_scale_mode(capsys):
    bench.main(['--cluster-scale', '1400', '--device', 'cpu'])
    line = _line(capsys, 'cluster-scale')
    assert line['n_clusters'] == 2 and line['verified_groups'] == 5


def test_no_card_no_run(monkeypatch):
    """--device cuda (the default) without a card fails; it never falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA card'):
        bench.main([])


@pytest.fixture(scope='module')
def two_groups():
    data = make_cluster_scale_data(1400, 700)
    cfg = ClusterConfig(exact_cap_replay=False)
    _, edges, _ = cluster.query_graph(
        data, cfg.overlap, list(cfg.jaccard_cutoffs), cfg.edge_threshold,
        cfg.qlen_diff, cfg.n_alignment_diff, cfg, CPU)
    return data, edges


@pytest.mark.parametrize('tamper', ['none', 'drop', 'add'])
def test_cluster_scale_check_raises_on_tampered_edges(two_groups, tamper):
    data, edges = two_groups
    edges = list(edges)
    if tamper == 'drop':
        del edges[len(edges) // 2]
    elif tamper == 'add':
        have = {tuple(sorted(e)) for e in edges}
        edges.append(next((a, b) for a in range(700, 1400)
                          for b in range(a + 1, 1400)
                          if (a, b) not in have))
    if tamper == 'none':
        assert bench.verify_groups(data, edges, 700, [0, 1], CPU) == 2
    else:
        with pytest.raises(AssertionError, match='differs from the host'):
            bench.verify_groups(data, edges, 700, [0, 1], CPU)
