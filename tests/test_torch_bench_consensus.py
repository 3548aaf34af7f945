"""``python -m fslr_tpu_torch.bench --consensus --reads 60 --device cpu``:
one JSON line on stdout with bench.py's keys of the mode (and 'device'),
the consensus stage's profile cells counted."""

from fslr_tpu_torch import bench
from tests.test_torch_bench_modes import _line


def test_consensus_mode(capsys):
    bench.main(['--consensus', '--reads', '60', '--device', 'cpu'])
    line = _line(capsys, 'consensus')
    assert '60 synthetic fusion reads, 20 clusters' in line['metric']
    assert line['profile_cells'] > 0
    assert line['stage_cells_per_s']['consensus'] > 0
