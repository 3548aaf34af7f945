"""A corrupt seed-index cache: the port warns and rebuilds, as fslr_tpu does.

Each package runs the golden scenario of tests/test_golden_snapshot.py on
its own copy of the reference; then its ``{ref}.fslr_k{k}.npz`` cache is
truncated to a few bytes, its mtime kept fresh, and the pipeline runs
again.  The second run must warn that the cache is unreadable, give the
first run's artifacts, and the two packages' second runs must give equal
artifacts.  An empty cache is held at the index loader itself.
"""

import contextlib
import glob
import gzip
import io
import os

import numpy as np
import pytest
import torch

from fslr_tpu.config import PipelineConfig as JaxPipelineConfig
from fslr_tpu.pipeline import _load_indexed as jax_load_indexed
from fslr_tpu.pipeline import run_pipeline as jax_run_pipeline
from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.pipeline import _load_indexed, run_pipeline
from tests.test_golden_snapshot import _build

ARTIFACTS = ('.mappings.bed', '.filter_counts_summary.csv',
             '.without_primers.fq', '.bwa_dodi.bam.bai')


def _run(pkg, ref, fq, out):
    """One run of ``pkg`` ('jax' or 'torch'); returns (output base,
    stderr)."""
    cls = JaxPipelineConfig if pkg == 'jax' else PipelineConfig
    config = cls(name='G', out=out, ref=ref, primers=('21q1', '17p6'),
                 basecalled=fq, skip_clustering=True, exact_cigars=False)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        if pkg == 'jax':
            jax_run_pipeline(config, backend='jax')
        else:
            run_pipeline(config, torch.device('cpu'))
    return os.path.join(out, 'G'), err.getvalue()


def _corrupt(ref, kind):
    """Truncate (or empty) the cache and keep it newer than ``ref``."""
    (cache,) = glob.glob(ref + '.fslr_k*.npz')
    with open(cache, 'r+b') as fh:
        fh.truncate(6 if kind == 'truncated' else 0)
    mtime = os.path.getmtime(ref) + 10
    os.utime(cache, (mtime, mtime))
    return cache


def _artifacts(base):
    out = {}
    for suffix in ARTIFACTS:
        with open(base + suffix, 'rb') as fh:
            out[suffix] = fh.read()
    with open(base + '.bwa_dodi.bam', 'rb') as fh:
        out['.bwa_dodi.bam records'] = gzip.decompress(fh.read())
    return out


@pytest.fixture(scope='module')
def cache_runs(tmp_path_factory):
    """pkg -> (first run's artifacts, second run's artifacts, second run's
    stderr, the cache) after truncating the cache between the runs."""
    runs = {}
    for pkg in ('torch', 'jax'):
        root = str(tmp_path_factory.mktemp(pkg))
        ref, fq = _build(root)
        first, _ = _run(pkg, ref, fq, os.path.join(root, 'first'))
        cache = _corrupt(ref, 'truncated')
        second, err = _run(pkg, ref, fq, os.path.join(root, 'second'))
        runs[pkg] = (_artifacts(first), _artifacts(second), err, cache)
    return runs


@pytest.mark.parametrize('pkg', ['torch', 'jax'])
def test_corrupt_cache_is_rebuilt_with_a_warning(cache_runs, pkg):
    first, second, err, cache = cache_runs[pkg]
    assert 'WARNING: seed-index cache' in err and 'unreadable' in err
    assert 'rebuilding from' in err
    assert second == first
    with np.load(cache) as z:          # the rebuilt cache is readable
        assert 'counts' in z and 'positions' in z


def test_second_runs_equal_across_packages(cache_runs):
    assert cache_runs['torch'][1] == cache_runs['jax'][1]


def test_empty_cache_is_rebuilt_as_fslr_tpu_rebuilds_it(tmp_path):
    ref, _ = _build(str(tmp_path))
    k = PipelineConfig().align.seed_k
    want = _load_indexed(ref, k)[1]                  # builds, writes
    got = {}
    for pkg, load in (('torch', _load_indexed), ('jax', jax_load_indexed)):
        _corrupt(ref, 'empty')
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            got[pkg] = load(ref, k)[1]
        assert 'unreadable' in err.getvalue(), pkg
    for sidx in got.values():
        np.testing.assert_array_equal(sidx.counts, want.counts)
        np.testing.assert_array_equal(sidx.positions, want.positions)
