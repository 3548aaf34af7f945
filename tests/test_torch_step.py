"""The port's fused device step (fslr_tpu_torch/parallel/step.py) against
fslr_tpu's (fslr_tpu/parallel/step.py, jit on the CPU) on the same seeded
inputs: every per-read output and all six counters equal exactly.  And
tools/synth.step_inputs builds __graft_entry__._example_inputs' ten
arrays.  The sharded step: tests/test_torch_step_mesh.py."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from fslr_tpu.config import PipelineConfig as JaxPipelineConfig
from fslr_tpu.parallel.step import make_device_step as jax_device_step
from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.encode import decode, encode, revcomp_str
from fslr_tpu_torch.ops import kmer_stats, tantan
from fslr_tpu_torch.panel import load_panel
from fslr_tpu_torch.parallel import step as tstep
from fslr_tpu_torch.tools.synth import step_inputs
from tests.oracles import mutate

CPU = torch.device('cpu')
L, B = 512, 16


def _reads(rng, genome):
    """16 reads of every kind the step tells apart: genome segments, a
    fusion between primer targets, a short read, a tandem repeat (junk),
    a telomere repeat (masked, not junk), a primer in the interior
    (concatemer), N runs, the other strand, an empty read, a read of the
    full width and a mutated segment."""
    panel = load_panel()
    t21, t17 = panel.targets['21q1'], panel.targets['17p6']

    def seg(n):
        p = int(rng.integers(0, len(genome) - n))
        return decode(genome[p:p + n])

    def rand(n):
        return decode(rng.integers(0, 4, n).astype(np.uint8))

    seqs = [seg(400) for _ in range(5)]
    seqs += [
        t21 + seg(180) + seg(180) + revcomp_str(t17),
        seg(150),
        rand(100) + 'AT' * 150 + rand(100),
        rand(60) + 'CCCTAA' * 50 + rand(60),
        seg(180) + panel.seqs['16p1'] + seg(180),
        seg(120) + 'N' * 40 + seg(200) + 'N' * 7 + seg(100),
        revcomp_str(seg(400)),
        '',
        seg(L),
        decode(mutate(rng, encode(seg(450)), sub=0.03, indel=0.01)),
        t21 + seg(300),
    ]
    assert len(seqs) == B
    return seqs


def seeded_inputs():
    """The step's ten arguments (full panel) on the CPU, NP and the
    number of seed positions at L."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, 1 << 16).astype(np.uint8)
    args = step_inputs(genome, _reads(rng, genome), L, CPU)
    config = PipelineConfig()
    n_seed = (L - config.align.seed_k) // config.align.seed_stride + 1
    return args, args[2].shape[0], n_seed


@pytest.fixture(scope='module')
def runs():
    args, NP, n_seed = seeded_inputs()
    jax_out = jax.jit(jax_device_step(JaxPipelineConfig(), NP, L, n_seed))(
        *(jax.numpy.asarray(a.numpy()) for a in args))
    single = tstep.make_device_step(PipelineConfig(), NP, L, n_seed)
    return dict(args=args, jax=jax.tree.map(np.asarray, jax_out),
                torch=single(*args))


def test_step_equals_fslr_tpu(runs):
    """Every per-read output and every counter equal exactly (integers,
    or floats that hold integers)."""
    want, got = runs['jax'], runs['torch']
    assert set(got) == set(want)
    for key, w in want.items():
        if key == 'counters':
            assert {k: int(v) for k, v in got[key].items()} == \
                {k: int(v) for k, v in w.items()}
            continue
        g = got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


def test_step_inputs_tell_the_kinds_apart(runs):
    """The seeded batch holds a junk read, a short read, a concatemer,
    fusion reads with two segments selected and an empty read; and no
    mask decision lies within 1e-4 of the posterior threshold (there the
    port's plain mask and fslr_tpu's may disagree)."""
    out = runs['torch']
    assert out['junk'].tolist()[7] and not out['junk'].tolist()[8]
    assert out['short'].tolist()[6] and out['short'].tolist()[12]
    assert out['concat'].tolist()[9]
    assert int(out['sel_chosen'][5].sum()) == 2
    assert int(out['counters']['aligned_segments']) > B // 2
    reads, lens = runs['args'][:2]
    cfg = PipelineConfig().junk
    post = tantan.repeat_posterior(reads, cfg)
    inside = (torch.arange(L)[None, :] < lens[:, None]) & (reads != 4)
    near = (post - cfg.mask_posterior_threshold).abs() < 1e-4
    assert not bool((near & inside).any())


def test_junk_blocks_use_the_given_telomere_table(runs):
    """The step hands its tel_table argument to junk_blocks: a table that
    holds every 6-mer makes the tandem-repeat read's block telomeric,
    so not junk."""
    reads, lens = runs['args'][:2]
    cfg = PipelineConfig().junk
    mask = tantan.repeat_mask(reads, lens, cfg)
    assert kmer_stats.junk_blocks(reads, lens, mask, cfg,
                                  tel_table=runs['args'][6]).tolist() == \
        runs['torch']['junk'].tolist()
    every = torch.ones(5 ** 6, dtype=torch.bool)
    assert not kmer_stats.junk_blocks(reads, lens, mask, cfg,
                                      tel_table=every).any()


def test_step_refuses_another_width(runs):
    step = tstep.make_device_step(PipelineConfig(), 12, 256, 82)
    with pytest.raises(ValueError, match='L = 256'):
        step(*runs['args'])


def test_step_inputs_match_example_inputs():
    """step_inputs on _example_inputs' genome, reads and two-primer panel
    gives its ten arrays."""
    want, NP = graft._example_inputs(L=L, B=B)
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 1 << 16).astype(np.uint8)
    seqs = []
    for _ in range(B):
        pos = rng.integers(0, len(genome) - 400)
        seqs.append(decode(genome[pos:pos + 400]))
    got = step_inputs(genome, seqs, L, CPU, primers=('21q1', '17p6'))
    assert got[2].shape[0] == NP
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
