"""fslr_tpu_torch/tools/cap_sweep.py against fslr_tpu's sweep on the CPU.

The port's numpy frame maker must equal tests/test_reference_oracle's
make_frame column by column, and the sweep (the port's closed form
against its exact host walk) must print fslr_tpu's totals (its device
path against the reference walk) on the same seeds, among them one of
the four where fslr_tpu found a partition that differs.
"""

import json

import numpy as np
import pytest
import torch

from fslr_tpu.tools import cap_sweep as jsweep
from fslr_tpu_torch.tools import cap_sweep as tsweep
from tests.test_reference_oracle import make_frame

CPU = torch.device('cpu')
# fslr_tpu's sweep found the partition changed on these frames
# (tests/test_torch_capwalk.py)
MISMATCH_SEEDS = [20, 159, 183, 857]


def _sweep_frames(seed):
    """Both frame makers on the sweep's draws from ``seed``."""
    out = []
    for maker in (make_frame, tsweep.make_frame):
        rng = np.random.default_rng(seed)
        out.append(maker(rng, n_groups=int(rng.integers(1, 5)),
                         max_members=int(rng.integers(12, 40)),
                         n_noise=int(rng.integers(0, 10))))
        out.append(int(rng.choice([3, 5, 10, 10, 10])))
    return out


@pytest.mark.parametrize('seed', [1, 2, 20, 183, 700])
def test_frame_maker_equals_make_frame(seed):
    want, want_cap, got, got_cap = _sweep_frames(seed)
    assert list(got) == list(want.columns)
    for col in want.columns:
        w = want[col].to_numpy()
        assert got[col].dtype == w.dtype, col
        assert got[col].tolist() == w.tolist(), col
    assert got_cap == want_cap        # the draws after the frame agree
    assert len(set(want['qname'])) > 10


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_totals_equal_fslr_tpus(capsys):
    """Ten frames from seed 20: the port's sweep on the CPU prints
    fslr_tpu's JSON line (seed 20 is a partition mismatch in both) and
    exits 1 as it does."""
    argv = ['--cases', '10', '--seed0', '20']
    rc_j = jsweep.main(argv)
    want = _last_json(capsys.readouterr().out)
    rc_t = tsweep.main(argv + ['--device', 'cpu'])
    out = capsys.readouterr()
    got = _last_json(out.out)
    assert got == want
    assert want['mismatch_seeds'] == [20] and want['edge_diff_frames'] > 0
    assert rc_t == rc_j == 1
    assert '"case_seed": 20, "PARTITION_MISMATCH": true' in out.err


@pytest.mark.parametrize('seed', MISMATCH_SEEDS)
def test_records_of_the_mismatch_seeds(seed):
    """On each of fslr_tpu's four mismatch frames the port's closed form
    changes the partition too, with edge sets that differ."""
    rec, = tsweep.sweep(1, seed, CPU)
    assert rec['seed'] == seed
    assert not rec['partition_ok'] and rec['edge_sym_diff'] > 0
    assert tsweep.totals([rec])['mismatch_seeds'] == [seed]
