"""The port's sharded step (fslr_tpu_torch/parallel/step.py:
make_sharded_step) on CPU meshes of 2 and 3 entries equals its single
step on tests/test_torch_step.py's 16 seeded reads: 3 entries pad the
batch to 18 rows (dp_call repeats the last row), and the counters must
count the 16 real rows only."""

import pytest
import torch

from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.parallel import step as tstep
from fslr_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_step import L, seeded_inputs


@pytest.fixture(scope='module')
def single():
    args, NP, n_seed = seeded_inputs()
    return args, NP, n_seed, tstep.make_device_step(
        PipelineConfig(), NP, L, n_seed)(*args)


@pytest.mark.parametrize('n', [2, 3])
def test_sharded_step_equals_single(single, n):
    args, NP, n_seed, want = single
    got = tstep.make_sharded_step(make_mesh(n, 'cpu'), PipelineConfig(), NP,
                                  L, n_seed)(*args)
    assert set(got) == set(want)
    for key, v in want.items():
        if key == 'counters':
            assert {k: int(c) for k, c in got[key].items()} == \
                {k: int(c) for k, c in v.items()}
            assert int(v['total_kept']) + int(v['total_dropped']) == 16
        else:
            assert torch.equal(got[key], v), key
