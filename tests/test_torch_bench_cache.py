"""chip_smoke.py's phase 13 leaves the bench's CPU-baseline cache as it
found it: its baseline runs beside other phases, so the bench runs of the
phase may read it, but no later ``python -m fslr_tpu_torch.bench`` may."""

import contextlib
import json

import pytest

import chip_smoke
from fslr_tpu_torch import bench

CONTENDED = {'cpu_reads_per_s': 10.51}


class _FinishedBaseline:
    """``subprocess.Popen`` in place of ``python -m fslr_tpu_torch.bench
    --cpu-baseline``: a process that has printed CONTENDED and ended."""

    def __init__(self, args, stdout, stderr, **kw):
        assert args[-2:] == ['fslr_tpu_torch.bench', '--cpu-baseline']
        stdout.write(json.dumps(CONTENDED) + '\n')

    def wait(self, timeout=None):
        return 0

    def poll(self):
        return 0


@pytest.mark.parametrize('fails', [False, True],
                         ids=['phase_passes', 'phase_fails'])
@pytest.mark.parametrize('old', [b'{"cpu_reads_per_s": 45.29}', None],
                         ids=['cache_held_bytes', 'cache_absent'])
def test_phase_13_leaves_the_bench_cache_as_it_found_it(
        tmp_path, monkeypatch, old, fails):
    cache = tmp_path / '_build' / 'bench_baseline.json'
    monkeypatch.setattr(bench, 'BASELINE_CACHE', str(cache))
    if old is not None:
        cache.parent.mkdir()
        cache.write_bytes(old)
    monkeypatch.setattr(chip_smoke.subprocess, 'Popen', _FinishedBaseline)
    root = tmp_path / 'cpu_baseline'
    root.mkdir()
    failed = pytest.raises(RuntimeError) if fails else \
        contextlib.nullcontext()
    with failed:
        with chip_smoke.cpu_baseline_beside(str(root)) as baseline:
            rps, _, _ = chip_smoke.cpu_baseline_done(*baseline)
            assert rps == CONTENDED['cpu_reads_per_s']
            # the phase's own bench runs read the contended baseline
            assert bench.cpu_baseline() == CONTENDED['cpu_reads_per_s']
            if fails:
                raise RuntimeError('a phase failed')
    if old is None:
        assert not cache.exists()
    else:
        assert cache.read_bytes() == old
