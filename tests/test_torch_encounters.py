"""fslr_tpu_torch's scale path of breakpoint clustering (ops/encounters.py,
capwalk.resolve_device) against fslr_tpu's on the CPU.

Each scenario goes through fslr_tpu's query_graph on its host path and on
its device path (JAX on the CPU), and through the port's on the CPU, with
the entries on the device (in-HBM and sharded) and with them spilled to
the host.
Edges (in order), node order and match rows must be equal: exact, no
tolerance.  build_entries itself is held to fslr_tpu's on its bounds and
entries at several slice sizes.
"""

import dataclasses as dc
import functools

import jax
import numpy as np
import pytest
import torch

from fslr_tpu.config import ClusterConfig
from fslr_tpu.ops import encounters as jenc
from fslr_tpu.stages import cluster as jC
from fslr_tpu_torch.ops import capwalk as tcw
from fslr_tpu_torch.ops import encounters as tenc
from fslr_tpu_torch.stages import cluster as tC
from fslr_tpu_torch.stages import mapping_table
from fslr_tpu_torch.tools.synth import make_cluster_scale_data
from tests.test_cluster import (CFG, CHR_LEN, _bed, _fusion_read,
                                _mixed_dataset, _read_rows)
from tests.test_reference_oracle import make_frame
from tests.test_torch_env import port_config

CPU = torch.device('cpu')
HOST = dict(device_enum_min_encounters=1 << 62, exact_cap_replay=False)
# enum_spill_min_encounters=1 sends every stream past the in-HBM path:
# to the sharded path, or to the spill where SPILL_DIRECT_MIN is 0
PAST_IN_HBM = dict(enum_spill_min_encounters=1)


def _force_path(path, monkeypatch) -> dict:
    """The ClusterConfig fields (and, for the spill, SPILL_DIRECT_MIN)
    that send the port's scale path to ``path``."""
    if path == 'spill':
        monkeypatch.setattr(tenc, 'SPILL_DIRECT_MIN', 0)
    return {} if path == 'in_hbm' else PAST_IN_HBM


def _random_soup():
    """tests/test_cluster.py's random soup: 10 groups of 40 jittered
    reads, plus the borderline reads BL0 and BL1 (qlen2 ratio 2400/2500
    equals 1 - qlen_diff exactly; n_alignments 3/5 fails)."""
    rng = np.random.default_rng(42)
    reads = []
    for g in range(10):
        base = 1_000_000 + g * 300_000
        for i in range(40):
            reads.append(_fusion_read(f'R{g:02d}_{i:02d}.x', base,
                                      jitter=int(rng.integers(0, 120))))
    reads.append(_read_rows('BL0.x', [
        ('chr2', 8_000_000, 8_000_500, 0, 500),
        ('chr1', 5_000_000, 5_001_000, 500, 2900),
        ('chr2', 8_100_000, 8_100_500, 2900, 3400)], qlen=3400))
    reads.append(_read_rows('BL1.x', [
        ('chr2', 8_000_000, 8_000_300, 0, 300),
        ('chr1', 5_000_000, 5_000_800, 300, 1100),
        ('chr1', 5_000_700, 5_001_500, 1100, 1900),
        ('chr1', 5_001_400, 5_002_300, 1900, 2800),
        ('chr2', 8_100_000, 8_100_300, 2800, 3100)], qlen=3100))
    return _bed(reads)


def _scale_soup():
    """tests/test_cluster.py's 8 x 30 scale soup."""
    rng = np.random.default_rng(17)
    return _bed([_fusion_read(f'Q{g:02d}_{i:02d}.x', 1_000_000 + g * 400_000,
                              jitter=int(rng.integers(0, 100)))
                 for g in range(8) for i in range(30)])


def _gate_rounding():
    """Three reads at one breakpoint whose qlen2 ratios lie within float32
    rounding of 1 - qlen_diff = 0.96: 95,999,999 / 100,000,000 fails in
    float64 (the reference's arithmetic) and passes in float32, and
    their n_alignments ratio 3/5 fails, so only a float64 gate drops the
    pair; 96,000,001 / 100,000,000 passes both ways."""
    def read(name, qlen2, n_fill):
        fills = [('chr1', 5_000_000 + 900 * k, 5_001_000 + 900 * k,
                  300 + 1000 * k, 1300 + 1000 * k) for k in range(n_fill)]
        c, rs, re_, qs, _ = fills[-1]
        fills[-1] = (c, rs, re_, qs, 300 + qlen2)
        return _read_rows(name, [('chr2', 8_000_000, 8_000_300, 0, 300)]
                          + fills + [('chr2', 8_100_000, 8_100_300,
                                      300 + qlen2, 600 + qlen2)],
                          qlen=600 + qlen2)
    return _bed([read('GA.x', 100_000_000, 1), read('GB.x', 95_999_999, 3),
                 read('GC.x', 96_000_001, 3)])


# scenario -> (bed, the device path's settings)
SCENARIOS = {
    'mixed': (_mixed_dataset, dict(device_enum_min_encounters=1)),
    'random_soup_small_slices': (_random_soup, dict(
        device_enum_min_encounters=1, enum_slice_cap=4096,
        enum_merge_cap=8192)),
    'scale_soup': (_scale_soup, dict(device_enum_min_encounters=1,
                                     enum_slice_cap=4096)),
}


def _data(bed):
    b, lens, _, _ = jC.rename_chromosomes(bed, CHR_LEN, set())
    return jC.prepare_data(jC.keep_fillings(b), set(), lens)


def _jax_graph(data, cfg):
    m, e, n = jC.query_graph(data, cfg.overlap, list(cfg.jaccard_cutoffs),
                             cfg.edge_threshold, cfg.qlen_diff,
                             cfg.n_alignment_diff, cfg)
    return (set(zip(m['query1'], m['query2'], m['jaccard_similarity'])), e,
            list(n.items()))


def _port_graph(data, cfg, stats=None):
    cfg = port_config(cfg)
    m, e, n = tC.query_graph(data, cfg.overlap, list(cfg.jaccard_cutoffs),
                             cfg.edge_threshold, cfg.qlen_diff,
                             cfg.n_alignment_diff, cfg, CPU, stats)
    return m, e, list(n.items())


@pytest.fixture(scope='module')
def jax_graphs():
    """fslr_tpu's host and device graphs of every scenario, once."""
    out = {}
    for name, (make, kw) in SCENARIOS.items():
        data = _data(make())
        out[name] = (_jax_graph(data, dc.replace(CFG, **HOST)),
                     _jax_graph(data, dc.replace(CFG, **kw)))
    return out


@pytest.mark.parametrize('path', ['in_hbm', 'sharded', 'spill'])
@pytest.mark.parametrize('scenario', list(SCENARIOS))
def test_scale_path_matches_fslr_tpu(jax_graphs, scenario, path,
                                     monkeypatch):
    make, kw = SCENARIOS[scenario]
    j_host, j_dev = jax_graphs[scenario]
    assert j_dev == j_host                     # the reference's own claim
    stats = {}
    got = _port_graph(_data(make()), dc.replace(
        CFG, **kw, **_force_path(path, monkeypatch)), stats)
    assert stats['path'] == {'in_hbm': 'in-HBM'}.get(path, path)
    assert got[1] == j_dev[1]                  # edges, in order
    assert got[2] == j_dev[2]                  # node order
    assert got[0] == j_dev[0]                  # match rows
    assert len(got[1]) > 20


def _build_args(scenario, monkeypatch):
    """The arguments query_graph gives the port's build_entries."""
    make, kw = {**SCENARIOS, 'gate_rounding': (
        _gate_rounding, dict(device_enum_min_encounters=1))}[scenario]
    calls = []
    orig = tenc.build_entries

    def spy(*a):
        calls.append(a)
        return orig(*a)

    monkeypatch.setattr(tenc, 'build_entries', spy)
    _port_graph(_data(make()), dc.replace(CFG, **kw))
    monkeypatch.setattr(tenc, 'build_entries', orig)
    return calls[0]


def _jax_jobs(jobs):
    return [jenc.ChromJob(starts=j.starts, ends=j.ends, lo=j.lo,
                          ccum=j.ccum, rid=j.rid, irk=j.irk) for j in jobs]


def _device_entries(ents, mi, mn):
    """(ei, eo, run jump) of a device entry set, in-HBM or sharded, from
    its buckets' traversal keys in global order: the run jump of an entry
    is the first later entry of another (query, interval) run, as
    fslr_tpu's fetch_all gives it.  The buckets' bases must be their
    global offsets."""
    buckets = ents.device_buckets()
    sizes = [b[3] for b in buckets]
    assert [b[2] for b in buckets] == [int(x) for x in
                                       np.cumsum([0] + sizes)[:-1]]
    assert sum(sizes) == ents.E
    key = np.concatenate([np.zeros(0, np.int64)]
                         + [b[0].cpu().numpy() for b in buckets])
    eo = np.concatenate([np.zeros(0, np.int32)]
                        + [b[1].cpu().numpy() for b in buckets])
    run = key // mn
    return ((run % mi).astype(np.int32), eo,
            np.searchsorted(key, (run + 1) * mn).astype(np.int32))


@pytest.mark.parametrize('slice_cap', [257, 4096, 1 << 25])
@pytest.mark.parametrize('scenario', ['mixed', 'random_soup_small_slices',
                                      'gate_rounding'])
def test_build_entries_matches_fslr_tpu(scenario, slice_cap, monkeypatch):
    """In-HBM entries == fslr_tpu's x64 device build, spill entries ==
    its host-spill build: bounds, (ei, eo), and the run jumps of the
    device-resident set; in several slices (257 encounters: many slices
    and merges).  The gate_rounding scenario needs the float64 gate."""
    (jobs, R, mi, mn, qlen2, naln, tq, tn, _, merge_cap, _, _,
     _) = _build_args(scenario, monkeypatch)
    common = (R, mi, mn, qlen2, naln, tq, tn, slice_cap)
    want = jenc.build_entries(_jax_jobs(jobs), *common,
                              merge_cap=4 * slice_cap,
                              spill_min_encounters=1 << 62)
    with jax.enable_x64():
        want_spill = jenc._build_entries_spill(_jax_jobs(jobs), *common)
    got = tenc.build_entries(jobs, *common, 4 * slice_cap, 1 << 62, CPU)
    monkeypatch.setattr(tenc, 'SPILL_DIRECT_MIN', 0)        # the spill
    got_spill = tenc.build_entries(jobs, *common, merge_cap, 0, CPU)
    assert isinstance(got, tenc.EntrySet)
    assert isinstance(got_spill, tenc.HostEntrySet)
    assert got.E == want.E == got_spill.E == want_spill.E > 0
    for g, w in ((got, want), (got_spill, want_spill)):
        np.testing.assert_array_equal(g.bounds, w.bounds)
    for a, b in zip(_device_entries(got, mi, mn), want.fetch_all()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip((got_spill.ei, got_spill.eo), want_spill.fetch_all()[:2]):
        np.testing.assert_array_equal(a, b)


def test_build_entries_of_nothing(monkeypatch):
    """No encounter: an empty entry set, on the three paths."""
    job = tenc.ChromJob(*(np.zeros(1, np.int64) for _ in range(3)),
                        ccum=np.zeros(2, np.int64),
                        rid=np.zeros(1, np.int64), irk=np.zeros(1, np.int64))
    args = ([job], 1, 1, 2, np.ones(1), np.ones(1), 0.96, 0.75, 64, 64)
    ents = tenc.build_entries(*args, 1 << 62, CPU)
    assert isinstance(ents, tenc.EntrySet)
    assert ents.E == 0 and list(ents.bounds) == [0, 0]
    assert ents.device_buckets()[0][0].numel() == 0
    ents = tenc.build_entries(*args, -1, CPU)
    assert isinstance(ents, tenc.ShardedEntrySet)
    assert ents.E == 0 and list(ents.bounds) == [0, 0]
    assert ents.device_buckets() == []
    assert all(len(x) == 0 for x in _device_entries(ents, 1, 2))
    monkeypatch.setattr(tenc, 'SPILL_DIRECT_MIN', -1)       # the spill
    ents = tenc.build_entries(*args, -1, CPU)
    assert isinstance(ents, tenc.HostEntrySet)
    assert ents.E == 0 and list(ents.bounds) == [0, 0]
    assert len(ents.ei) == len(ents.eo) == 0


def _cluster_beds(tmp_path, bed_df, cfg, tag):
    """The port's cluster stage on ``bed_df`` (written as mappings.bed):
    {suffix: bytes}, or None when no cluster was found."""
    path = str(tmp_path / f'{tag}.mappings.bed')
    bed_df.to_csv(path, sep='\t', index=False)
    res = tC.cluster_stage(tC.read_mappings(path),
                           {f'chr{c}': 10_000_000 for c in range(1, 4)},
                           port_config(cfg), CPU)
    if res.no_clusters:
        return None
    out = {}
    for suffix, bed in (('.cluster.bed', res.cluster_bed),
                        ('.representative.bed', res.representative_bed)):
        p = str(tmp_path / f'{tag}{suffix}')
        mapping_table.write_mappings_bed(bed, p)
        with open(p, 'rb') as fh:
            out[suffix] = fh.read()
    return out


def test_value_and_replay_host_chunked_matches_flat(tmp_path, monkeypatch):
    """The spill path's valuing and replay in query-aligned chunks of 7
    entries gives the beds of one chunk, on a capped frame."""
    bed = make_frame(np.random.default_rng(909), n_groups=3, max_members=14,
                     n_noise=5)
    bed = bed.assign(chrom=[f'chr{c}' for c in bed['chrom']])
    cfg = ClusterConfig(device_enum_min_encounters=0, edge_threshold=3)
    monkeypatch.setattr(tenc, 'SPILL_DIRECT_MIN', 0)        # the spill
    orig = tcw.value_and_replay_host
    outs = {}
    for label, ch in (('flat', 1 << 60), ('tiny', 7)):
        monkeypatch.setattr(tcw, 'value_and_replay_host',
                            functools.partial(orig, chunk=ch))
        outs[label] = _cluster_beds(tmp_path, bed, cfg, label)
    assert outs['flat'] is not None and outs['flat'] == outs['tiny']


def test_resolve_device_chunked_matches_flat(monkeypatch):
    """resolve_device's query-aligned chunks (down to one query a chunk)
    give the emissions of one chunk, on the capped mixed scenario."""
    data = _data(_mixed_dataset())
    cfg = dc.replace(CFG, device_enum_min_encounters=1)
    orig = tcw.resolve_device
    outs = {}
    for label, ch in (('flat', 1 << 40), ('tiny', 1)):
        monkeypatch.setattr(tcw, 'resolve_device',
                            functools.partial(orig, chunk=ch))
        outs[label] = _port_graph(data, cfg)
    assert outs['flat'] == outs['tiny']
    assert outs['flat'][1] == _jax_graph(data, cfg)[1]


@pytest.mark.parametrize('path', ['in_hbm', 'sharded', 'spill'])
def test_spill_query_ranges_ragged_tail(path, monkeypatch):
    """69 reads: the spill path's query ranges (ceil(69 / 64) = 2 reads)
    end in a range of one read; the three paths equal fslr_tpu's host
    path."""
    data = make_cluster_scale_data(69, group=69, seed=6969)
    assert len(data) == 69
    kw = dict(device_enum_min_encounters=0, exact_cap_replay=False)
    stats = {}
    got = _port_graph(data, ClusterConfig(
        **kw, **_force_path(path, monkeypatch)), stats)
    assert stats['path'] == {'in_hbm': 'in-HBM'}.get(path, path)
    want = _jax_graph(data, ClusterConfig(**HOST))
    assert got[1] == want[1] and got[2] == want[2] and got[0] == want[0]
    assert len(got[1]) > 100


def test_cluster_scale_data_is_bench_data():
    """tools/synth's cluster-scale data equals bench.run_cluster_scale's
    construction (1 interval a read, groups 5 kb apart, +-40 bp)."""
    n, group = 2_000, 700
    rng = np.random.default_rng(7)
    gid = np.repeat(np.arange(n // group, dtype=np.int64), group)[:n]
    start = 100_000 + gid * 5_000 + rng.integers(-40, 41, len(gid))
    end = start + 1_000 + rng.integers(-40, 41, len(gid))
    want = sorted([jC.IntervalItem(1, int(s), int(e), float(e - s), r, 3,
                                   1_000, int((e - s) // 2 + s), r)
                   for r, (s, e) in enumerate(zip(start, end))],
                  key=lambda it: it.start)
    got = make_cluster_scale_data(n, group)
    assert [tuple(x) for x in got] == [tuple(x) for x in want]
    assert len(got) == 1_400
