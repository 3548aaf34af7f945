"""fslr_tpu_torch.ops.poa (both engines) against fslr_tpu.ops.poa with
backend='jax' on the CPU.  Exact: the consensus strings must be equal."""

import numpy as np
import pytest
import torch

from fslr_tpu.config import ConsensusConfig
from fslr_tpu.encode import decode
from fslr_tpu.ops import poa as jpoa
from fslr_tpu_torch.ops import poa as tpoa
from tests.oracles import mutate, random_seq
from tests.test_torch_env import port_config

CPU = torch.device('cpu')


def _identical(rng):
    seq = decode(random_seq(rng, 420))
    return [[seq] * 5]


def _noisy(rng):
    original = random_seq(rng, 380)
    return [[decode(mutate(rng, original, sub=0.08, indel=0.04))
             for _ in range(7)]]


def _majority_insertion(rng):
    """4 of 6 members carry a 6-base insertion: the consensus keeps it."""
    original = random_seq(rng, 360)
    ins = random_seq(rng, 6)
    members = []
    for k in range(6):
        s = (np.concatenate([original[:200], ins, original[200:]])
             if k % 3 else original)
        members.append(decode(mutate(rng, s, sub=0.02, indel=0.0)))
    return [members]


def _mixed(rng):
    """Several clusters in one batch: two length buckets, an empty
    cluster, a singleton and a cluster above max_reads_per_cluster."""
    a = random_seq(rng, 150)
    b = random_seq(rng, 300)
    return [[decode(mutate(rng, a, sub=0.05, indel=0.02)) for _ in range(4)],
            [],
            [decode(b)],
            [decode(mutate(rng, b, sub=0.05, indel=0.02)) for _ in range(20)]]


CLUSTERS = {'identical': _identical, 'noisy': _noisy,
            'majority_insertion': _majority_insertion, 'mixed': _mixed}


@pytest.mark.parametrize('engine', ['poa', 'pileup'])
@pytest.mark.parametrize('case', list(CLUSTERS))
def test_consensus_equals_fslr_tpu(case, engine):
    clusters = CLUSTERS[case](np.random.default_rng(len(case)))
    cfg = ConsensusConfig(engine=engine)
    want = jpoa.consensus_sequences(clusters, cfg, backend='jax')
    got = tpoa.consensus_sequences(clusters, port_config(cfg), CPU)
    assert got == want
    if case == 'identical':
        assert got[0] == clusters[0][0]


def test_pileup_refine_equals_fslr_tpu():
    clusters = _noisy(np.random.default_rng(9))
    cfg = ConsensusConfig(engine='pileup', refine_iterations=1)
    assert tpoa.consensus_sequences(clusters, port_config(cfg), CPU) == \
        jpoa.consensus_sequences(clusters, cfg, backend='jax')
