"""fslr_tpu_torch's clustering against fslr_tpu's on the CPU: seeded
interval soups written as mappings.bed, clustered by both packages; the
cluster and representative beds must be byte-equal and the components
(members and order) equal.  Exact: no tolerance."""

import dataclasses
import os

import numpy as np
import pandas as pd
import pytest
import torch

from fslr_tpu.config import ClusterConfig
from fslr_tpu.ops import components as jcomp
from fslr_tpu.ops import jaccard as jjac
from fslr_tpu.stages import cluster as jcluster
from fslr_tpu_torch.ops import components as tcomp
from fslr_tpu_torch.ops import encounters as tenc
from fslr_tpu_torch.ops import jaccard as tjac
from fslr_tpu_torch.stages import cluster as tcluster
from fslr_tpu_torch.stages import mapping_table
from tests.test_cluster import (_bed, _fusion_read, _mixed_dataset,
                                _multi_filling_read, _read_rows)
from tests.test_torch_env import port_config

CPU = torch.device('cpu')
CHR_LEN = {'chr1': 10_000_000, 'chr2': 10_000_000, 'chr3': 900_000}


def _groups_and_singletons():
    reads = [_fusion_read(f'A{i}.x.21q1F_17p6R', 2_000_000, score=1000 + i)
             for i in range(4)]
    reads += [_fusion_read(f'B{i}.x.21q1F_17p6R', 3_000_000, chrom='chr2',
                           score=500 + (i % 2)) for i in range(3)]
    reads.append(_fusion_read('C0.x.21q1F_17p6R', 5_000_000, score=10))
    return _bed(reads)


def _all_clustered():
    """Every read of the bed is in a component: the cluster columns stay
    integers."""
    return _bed([_fusion_read(f'A{i}.x.21q1F_17p6R', 2_000_000,
                              jitter=i * 7) for i in range(5)])


def _soup(seed: int):
    """Random reads with 1-3 fillings around a few breakpoints (jittered
    starts and lengths, random scores), some labelled False, some on a
    small chromosome, plus 2-alignment reads without fillings."""
    rng = np.random.default_rng(seed)
    bps = [('chr1', 2_000_000), ('chr1', 2_000_600), ('chr2', 4_000_000),
           ('chr3', 600_000), ('chr1', 7_000_000)]
    reads = []
    for i in range(60):
        n_fill = int(rng.integers(1, 4))
        segs = [('chr2', 8_000_000, 8_000_500, 0, 500)]
        q = 500
        for _ in range(n_fill):
            c, s = bps[int(rng.integers(0, len(bps)))]
            s += int(rng.integers(-60, 61))
            ln = 1000 + int(rng.integers(-80, 81))
            segs.append((c, s, s + ln, q, q + ln))
            q += ln
        segs.append(('chr2', 8_100_000, 8_100_500, q, q + 500))
        label = '21q1F_17p6R' if rng.random() < 0.8 else 'False_17p6R'
        reads.append(_read_rows(f'R{i:03d}.x.{label}', segs, qlen=q + 500,
                                score=int(rng.integers(200, 3000))))
    for i in range(5):
        reads.append(_read_rows(f'T{i}.x.21q1F_17p6R',
                                [('chr1', 3_000_000, 3_000_500, 0, 500),
                                 ('chr2', 3_100_000, 3_100_500, 500, 1000)],
                                qlen=1000))
    return _bed(reads)


def _capped_group():
    """One 25-read group at one breakpoint pair: every query reaches the
    soft edge cap (the exact replay)."""
    return _bed([_multi_filling_read(f'G{i:02d}.x.21q1F_17p6R', 2_000_000,
                                     2_400_000, jitter=(i % 4) * 30)
                 for i in range(25)])


SCENARIOS = {
    'groups_and_singletons': (_groups_and_singletons, {}),
    'all_clustered': (_all_clustered, {}),
    'mixed_capped_multi_overcap': (_mixed_dataset, {}),
    'capped_group': (_capped_group, {}),
    'capped_closed_form': (_capped_group, dict(exact_cap_replay=False)),
    'soup': (lambda: _soup(1), {}),
    'soup_filter_false': (lambda: _soup(2), dict(filter_false=True)),
    'soup_chrom_mask': (lambda: _soup(3), dict(cluster_mask=('chr2',
                                                            'subtelomere'))),
    'soup_no_mask_high_coverage': (lambda: _soup(4), dict(
        cluster_mask=(), filter_high_coverage=True,
        high_coverage_threshold=30)),
    'soup_cutoffs': (lambda: _soup(5), dict(jaccard_cutoffs=(1, 0.5, 0.5),
                                            overlap=0.6, edge_threshold=3)),
}


def _run_both(tmp_path, bed_df, cfg, port_cfg=None):
    """Write the bed as mappings.bed, cluster it with both packages (the
    port with ``port_cfg`` where given); return ({suffix: bytes} per
    package, subgraphs per package)."""
    path = str(tmp_path / 'S.mappings.bed')
    bed_df.to_csv(path, sep='\t', index=False)
    out = {}
    jres = jcluster.cluster_stage(pd.read_csv(path, sep='\t',
                                              engine='pyarrow'),
                                  CHR_LEN, cfg)
    tres = tcluster.cluster_stage(tcluster.read_mappings(path), CHR_LEN,
                                  port_config(port_cfg or cfg), CPU)
    assert jres.no_clusters == tres.no_clusters
    if jres.no_clusters:
        return None, (jres.subgraphs, tres.subgraphs)
    for tag, res in (('jax', jres), ('torch', tres)):
        files = {}
        for suffix, bed in (('.cluster.bed', res.cluster_bed),
                            ('.representative.bed', res.representative_bed)):
            p = str(tmp_path / f'{tag}{suffix}')
            if tag == 'jax':
                bed.to_csv(p, index=False, sep='\t')
            else:
                mapping_table.write_mappings_bed(bed, p)
            with open(p, 'rb') as fh:
                files[suffix] = fh.read()
        out[tag] = files
    return out, (jres.subgraphs, tres.subgraphs)


@pytest.mark.parametrize('scenario', list(SCENARIOS))
def test_cluster_beds_byte_equal_to_fslr_tpu(tmp_path, scenario):
    make, kw = SCENARIOS[scenario]
    files, (jsub, tsub) = _run_both(tmp_path, make(), ClusterConfig(**kw))
    assert tsub == jsub                      # members and component order
    assert files is not None, 'scenario found no clusters'
    assert files['torch'] == files['jax']


def test_cluster_float_columns_once_a_read_is_a_singleton(tmp_path):
    files, _ = _run_both(tmp_path, _groups_and_singletons(), ClusterConfig())
    header, first = files['torch']['.cluster.bed'].decode().splitlines()[:2]
    cols = dict(zip(header.split('\t'), first.split('\t')))
    assert cols['cluster'].endswith('.0') and cols['n_reads'].endswith('.0')
    files, _ = _run_both(tmp_path, _all_clustered(), ClusterConfig())
    header, first = files['torch']['.cluster.bed'].decode().splitlines()[:2]
    cols = dict(zip(header.split('\t'), first.split('\t')))
    assert cols['cluster'] == '0' and cols['n_reads'] == '5'


@pytest.mark.parametrize('case', ['no_edges', 'subtelomere', 'qlen_gate'])
def test_no_clusters_as_fslr_tpu(tmp_path, case):
    if case == 'no_edges':
        bed = _bed([_fusion_read('A0.x.21q1F_17p6R', 2_000_000),
                    _fusion_read('B0.x.21q1F_17p6R', 3_000_000,
                                 chrom='chr2')])
    elif case == 'subtelomere':
        bed = _bed([_fusion_read(f'A{i}.x.21q1F_17p6R', 100_000)
                    for i in range(3)])
    else:
        bed = _bed([
            _read_rows('A0.x', [('chr2', 8_000_000, 8_000_500, 0, 500),
                                ('chr1', 2_000_000, 2_001_000, 500, 1500),
                                ('chr2', 8_100_000, 8_100_500, 1500, 2000)],
                       qlen=2000),
            _read_rows('A1.x', [('chr2', 8_000_000, 8_000_500, 0, 500),
                                ('chr1', 2_000_000, 2_001_000, 500, 3500),
                                ('chr2', 8_100_000, 8_100_500, 3500, 4000)],
                       qlen=4000)])
    files, (jsub, tsub) = _run_both(tmp_path, bed, ClusterConfig())
    assert files is None and tsub == jsub


@pytest.mark.parametrize('store', ['in_hbm', 'sharded', 'spill'])
def test_device_enumeration_cluster_stage(tmp_path, store, monkeypatch):
    """cluster_stage through the scale path (ops/encounters.py), with the
    entries on the device (in one set, or sharded) and spilled to the
    host: beds byte-equal to fslr_tpu's device path, and the same
    components."""
    cfg = ClusterConfig(device_enum_min_encounters=1)
    if store == 'spill':
        monkeypatch.setattr(tenc, 'SPILL_DIRECT_MIN', 0)
    port_cfg = cfg if store == 'in_hbm' else dataclasses.replace(
        cfg, enum_spill_min_encounters=1)
    files, (jsub, tsub) = _run_both(tmp_path, _mixed_dataset(), cfg,
                                    port_cfg)
    assert tsub == jsub
    assert files is not None and files['torch'] == files['jax']


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_components_equal_fslr_tpu(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 200))
    edges = rng.integers(0, n, (int(rng.integers(0, 3 * n)), 2))
    want = np.asarray(jcomp.connected_components_padded(
        edges.astype(np.int32), n))
    np.testing.assert_array_equal(
        tcomp.connected_components(edges, n, CPU), want)


def test_components_need_a_device():
    """The device is the caller's choice: a call without one raises
    instead of running on the CPU."""
    with pytest.raises(TypeError):
        tcomp.connected_components(np.zeros((1, 2), np.int64), 2)


def test_jaccard_pairs_match_host():
    """Greedy Jaccard from the uploaded tables equals the host mirror."""
    rng = np.random.default_rng(3)
    R, M = 30, 8
    lists = []
    for _ in range(R):
        n = int(rng.integers(1, M + 1))
        lst = []
        for _ in range(n):
            c = int(rng.integers(1, 3))
            s = int(rng.integers(0, 5000))
            e = s + int(rng.integers(100, 2000))
            lst.append((c, s, e, float(e - s)))
        lists.append(lst)
    tabs = [np.zeros((R, M), dt) for dt in (np.int32, np.int32, np.int32,
                                            np.float32)]
    lens = np.array([len(x) for x in lists], np.int32)
    for r, lst in enumerate(lists):
        for i, itv in enumerate(lst):
            for t, v in zip(tabs, itv):
                t[r, i] = v
    dev = tjac.upload_interval_arrays(*tabs, lens, CPU)
    pairs = rng.integers(0, R, (200, 2))
    j, n_i = tjac.jaccard_pairs_indexed(pairs, *dev, 0.8, M=M)
    for k, (a, b) in enumerate(pairs):
        je, ne = tjac.jaccard_host(lists[a], lists[b], 0.8)
        assert abs(float(j[k]) - je) < 1e-6 and int(n_i[k]) == ne, k


@pytest.mark.parametrize('M', [32, 4])
def test_jaccard_pairs_list_api_matches_fslr_tpu(M):
    """jaccard_pairs' list API on tests/test_cluster.py's 40 pairs (lists
    of 1-5 intervals) equals fslr_tpu's exactly, j and n_i; with M = 4
    the pairs with a longer list take the exact host mirror in both."""
    rng = np.random.default_rng(3)
    lists1, lists2 = [], []
    for _ in range(40):
        def mk():
            out = []
            for _ in range(rng.integers(1, 6)):
                c = int(rng.integers(1, 3))
                s = int(rng.integers(0, 5000))
                e = s + int(rng.integers(100, 2000))
                out.append((c, s, e, float(e - s)))
            return out
        lists1.append(mk())
        lists2.append(mk())
    assert max(map(len, lists1 + lists2)) > 4
    want = jjac.jaccard_pairs(lists1, lists2, 0.8, M=M)
    got = tjac.jaccard_pairs(lists1, lists2, 0.8, M=M, device=CPU)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert tjac.jaccard_pairs([], [], 0.8, device=CPU)[0].shape == (0,)


def test_read_mappings_types(tmp_path):
    path = os.path.join(tmp_path, 'x.bed')
    with open(path, 'w') as fh:
        fh.write('a\tb\tc\td\te\n1\t1.5\t\tx\t2\n3\t\t\t\t\n')
    cols = tcluster.read_mappings(path)
    assert cols['a'].dtype == np.int64 and cols['b'].dtype == np.float64
    assert np.isnan(cols['c']).all() and cols['e'].dtype == np.float64
    assert cols['d'][0] == 'x' and np.isnan(cols['d'][1])
