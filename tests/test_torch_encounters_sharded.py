"""The sharded encounter build of fslr_tpu_torch (ops/encounters.py:
``_build_entries_sharded``, ``ShardedEntrySet``) and build_entries'
three-way dispatch, against fslr_tpu's on the CPU.

The port's sharded entries must equal fslr_tpu's sharded build (under
``jax.enable_x64()``): the entry count, the per-query bounds and the
(interval rank, other read, run jump) of its ``fetch_all()``, derived
here from the port's buckets, exactly.  With
the bucket target made small, the buckets (B > 1 pk buckets, B2 > 1 query
buckets) concatenate to the in-HBM entries and no query spans two of
them.  An overflowing bucket and a card out of memory fall back to the
spill; each size range takes its path.
"""

import dataclasses as dc

import jax
import numpy as np
import pytest
import torch

from fslr_tpu.ops import encounters as jenc
from fslr_tpu_torch.ops import encounters as tenc
from tests.test_cluster import CFG
from tests.test_torch_encounters import (_build_args, _data, _device_entries,
                                         _jax_graph, _jax_jobs, _port_graph,
                                         _scale_soup)

CPU = torch.device('cpu')
SCENARIOS = ['mixed', 'random_soup_small_slices', 'gate_rounding']
SLICE_CAPS = [257, 4096]
# fslr_tpu's test_scale_enumeration_matches_host settings of its sharded
# path (tests/test_cluster.py)
SHARDED_CFG = dict(device_enum_min_encounters=1, enum_spill_min_encounters=1,
                   enum_slice_cap=4096)


@pytest.fixture(scope='module')
def args():
    """The arguments query_graph gives the port's build_entries, per
    scenario, once."""
    with pytest.MonkeyPatch.context() as mp:
        return {s: _build_args(s, mp) for s in SCENARIOS}


def _jax_sharded_fetch(jobs, common):
    with jax.enable_x64():
        es = jenc._build_entries_sharded(_jax_jobs(jobs), *common)
        return es.E, es.bounds, es.fetch_all()


@pytest.fixture(scope='module')
def jax_sharded(args):
    """fslr_tpu's sharded build of every scenario and slice cap, once.
    Its exchange parts (4M entries, fixed) and its accumulators' trim
    threshold are made small so that a 257-encounter slice costs a small
    sort (the values do not depend on them); the jitted part functions
    are traced anew for that and again after."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenc, '_PART', 1 << 10)
        mp.setattr(jenc._DevAcc, 'TRIM_AT', 1 << 12)
        try:
            jenc._pad_fn.cache_clear()
            jenc._slice_part_fn.cache_clear()
            for s in SCENARIOS:
                jobs, R, mi, mn, qlen2, naln, tq, tn = args[s][:8]
                for sc in SLICE_CAPS:
                    out[s, sc] = _jax_sharded_fetch(
                        jobs, (R, mi, mn, qlen2, naln, tq, tn, sc))
        finally:
            jenc._pad_fn.cache_clear()
            jenc._slice_part_fn.cache_clear()
    return out


def _build(a, slice_cap=None, spill_min=0):
    """The port's build_entries on ``a`` (query_graph's arguments) on the
    CPU; by default the sharded path (any stream > 0 encounters)."""
    jobs, R, mi, mn, qlen2, naln, tq, tn, sc, merge_cap = a[:10]
    stats = {}
    ents = tenc.build_entries(jobs, R, mi, mn, qlen2, naln, tq, tn,
                              slice_cap or sc, merge_cap, spill_min, CPU,
                              stats)
    return ents, stats


@pytest.mark.parametrize('slice_cap', SLICE_CAPS)
@pytest.mark.parametrize('scenario', SCENARIOS)
def test_sharded_matches_fslr_tpu(args, jax_sharded, scenario, slice_cap):
    E, bounds, fetched = jax_sharded[scenario, slice_cap]
    mi, mn = args[scenario][2:4]
    got, stats = _build(args[scenario], slice_cap)
    assert isinstance(got, tenc.ShardedEntrySet)
    assert stats['path'] == 'sharded' and 'fallback' not in stats
    assert got.E == E == stats['entries'] > 0
    np.testing.assert_array_equal(got.bounds, bounds)
    for a, b in zip(_device_entries(got, mi, mn), fetched):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('scenario,target', [
    ('mixed', 1 << 5), ('random_soup_small_slices', 1 << 8)])
def test_buckets_concatenate_to_in_hbm(args, scenario, target, monkeypatch):
    """With a bucket target of a few dozen or hundred encounters, B > 1
    pk buckets and B2 > 1 query buckets: their keys and other reads
    concatenate to the in-HBM entry set's, bucket bases are global
    offsets, no query spans two buckets, and the run jumps are the in-HBM
    set's."""
    a = args[scenario]
    mi, mn = a[2], a[3]
    in_hbm, st = _build(a, spill_min=1 << 62)
    assert st['path'] == 'in-HBM'
    monkeypatch.setattr(tenc, '_BUCKET_TARGET', target)
    got, stats = _build(a)
    assert stats['pk_buckets'] > 1 and stats['query_buckets'] > 1
    assert stats['pairs'] == st['pairs'] and got.E == in_hbm.E
    buckets = got.device_buckets()
    assert len(buckets) > 1
    (key, eo, _, _), = in_hbm.device_buckets()
    assert torch.equal(torch.cat([b[0] for b in buckets]), key)
    assert torch.equal(torch.cat([b[1] for b in buckets]), eo)
    assert [b[2] for b in buckets] == \
        list(np.cumsum([0] + [b[3] for b in buckets[:-1]]))
    starts = set(got.bounds.tolist())
    assert all(b[2] in starts for b in buckets)       # bucket = queries
    np.testing.assert_array_equal(got.bounds, in_hbm.bounds)
    for x, y in zip(_device_entries(got, mi, mn),
                    _device_entries(in_hbm, mi, mn)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('cause', ['overflow', 'oom', 'oom_then_spill_oom'])
def test_fallback_to_the_spill(args, cause, monkeypatch, capsys):
    """A bucket over _BUCKET_CAP (made 2^6) raises _ShardOverflow, and a
    card out of memory raises torch.cuda.OutOfMemoryError (made to here):
    both give the spill's entries, with the reason in stats['fallback']
    and fslr_tpu's warning; a spill out of memory retries with 4x smaller
    slices (the degradation ladder)."""
    a = args['random_soup_small_slices']
    with monkeypatch.context() as mp:
        mp.setattr(tenc, 'SPILL_DIRECT_MIN', 0)
        want, _ = _build(a)
    assert isinstance(want, tenc.HostEntrySet)
    if cause == 'overflow':
        monkeypatch.setattr(tenc, '_BUCKET_CAP', 1 << 6)
    else:
        def oom(*_):
            raise torch.cuda.OutOfMemoryError('CUDA out of memory')
        monkeypatch.setattr(tenc, '_build_entries_sharded', oom)
    if cause == 'oom_then_spill_oom':
        spill = tenc._build_entries_spill
        calls = []

        def spill_once(*p, **k):
            calls.append(p[8])
            if len(calls) == 1:
                raise torch.cuda.OutOfMemoryError('CUDA out of memory')
            return spill(*p, **k)
        monkeypatch.setattr(tenc, '_build_entries_spill', spill_once)
    got, stats = _build(a, slice_cap=1 << 22)
    assert isinstance(got, tenc.HostEntrySet) and stats['path'] == 'spill'
    err = capsys.readouterr().err
    assert 'falling back to host-spill path' in err
    if cause == 'overflow':
        assert stats['fallback'].startswith('overflow (')
    else:
        assert stats['fallback'] == 'exhausted device memory'
    if cause == 'oom_then_spill_oom':
        assert calls == [1 << 22, 1 << 20] and stats['spill_div'] == 4
        assert 'retrying at slice_cap/4' in err
    assert got.E == want.E
    for x, y in zip((got.ei, got.eo, got.bounds),
                    (want.ei, want.eo, want.bounds)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('path', ['in-HBM', 'sharded', 'spill'])
def test_dispatch_by_size(args, path, capsys):
    """Up to enum_spill_min_encounters: in-HBM; above it, up to
    SPILL_DIRECT_MIN: sharded; above that: the spill, with fslr_tpu's
    note.  All three hold the same entries."""
    a = args['mixed']
    n = sum(int(j.ccum[-1]) for j in a[0])
    spill_min, direct = {'in-HBM': (n, n), 'sharded': (n - 1, n),
                         'spill': (n - 1, n - 1)}[path]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tenc, 'SPILL_DIRECT_MIN', direct)
        got, stats = _build(a, spill_min=spill_min)
    assert stats['path'] == path and stats['encounters'] == n
    assert isinstance(got, {'in-HBM': tenc.EntrySet,
                            'sharded': tenc.ShardedEntrySet,
                            'spill': tenc.HostEntrySet}[path])
    assert ('host-spill path' in capsys.readouterr().err) == \
        (path == 'spill')
    want, _ = _build(a, spill_min=1 << 62)
    assert got.E == want.E > 0
    np.testing.assert_array_equal(got.bounds, want.bounds)


def test_spill_direct_min_defaults_to_the_constant(args, monkeypatch):
    """SPILL_DIRECT_MIN alone decides between the sharded path and the
    spill, read at call time (build_entries has no keyword for it)."""
    monkeypatch.setattr(tenc, 'SPILL_DIRECT_MIN', 0)
    assert _build(args['mixed'])[1]['path'] == 'spill'
    monkeypatch.setattr(tenc, 'SPILL_DIRECT_MIN', 1 << 62)
    assert _build(args['mixed'])[1]['path'] == 'sharded'


@pytest.fixture(scope='module')
def scale_soup_jax():
    """fslr_tpu's query_graph on tests/test_cluster.py's 8 x 30 scale
    soup through its sharded path, once."""
    return _jax_graph(_data(_scale_soup()), dc.replace(CFG, **SHARDED_CFG))


@pytest.mark.parametrize('target', ['default', 'small_buckets'])
def test_query_graph_sharded_matches_fslr_tpu(scale_soup_jax, target,
                                              monkeypatch):
    """query_graph through the port's sharded path (one bucket each way,
    and many) equals fslr_tpu's through its own: edges in order, node
    order and match rows."""
    if target == 'small_buckets':
        monkeypatch.setattr(tenc, '_BUCKET_TARGET', 1 << 8)
    stats = {}
    got = _port_graph(_data(_scale_soup()), dc.replace(CFG, **SHARDED_CFG),
                      stats)
    assert stats['path'] == 'sharded'
    assert (stats['query_buckets'] > 1) == (target == 'small_buckets')
    assert got[1] == scale_soup_jax[1]
    assert got[2] == scale_soup_jax[2]
    assert got[0] == scale_soup_jax[0]
    assert len(got[1]) > 20
