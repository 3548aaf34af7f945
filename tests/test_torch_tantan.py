"""fslr_tpu_torch repeat mask and junk-block scoring against fslr_tpu.

The mask must agree on every decision of the planted-repeat batch of
tests/test_junk_ops.py (float32 sums in another order move posteriors by
~1e-7, far from the 0.5 threshold there); the gates and junk decisions
must be equal, and the per-block statistics agree to float32 rounding.
"""

import numpy as np
import pytest
import torch

from fslr_tpu.config import JunkFilterConfig
from fslr_tpu.encode import batch_encode, decode
from fslr_tpu.ops import kmer_stats as jks
from fslr_tpu.ops import tantan as jtan
from fslr_tpu_torch.ops import kmer_stats as tks
from fslr_tpu_torch.ops import tantan as ttan
from tests.test_torch_env import port_config
from tests.oracles import random_seq

CFG = JunkFilterConfig()
TCFG = port_config(CFG)


def _planted(seed=7, B=16, L=512):
    """The planted-repeat batch of test_junk_ops: tandem repeats of
    assorted periods + an N run, ragged lengths."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for r, p in ((0, 7), (1, 3), (2, 64), (5, 11)):
        s = int(rng.integers(0, L - 400))
        seq[r, s:s + 400] = np.tile(seq[r, s:s + p], 400 // p + 1)[:400]
    seq[3, 200:230] = 4
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    return seq, lens


def _blocks_batch():
    """Reads with a random block, a tandem block, a telomeric block, and
    tandem blocks of 151 bp (junk) and 150 bp (not junk)."""
    rng = np.random.default_rng(0)
    r0 = decode(random_seq(rng, 600))
    r1 = 'ACGT' * 30 + ('ATTGGC' * 45) + 'TTAC' * 30
    r2 = 'GGTC' * 20 + ('TTAGGG' * 40) + 'CCAT' * 20
    r3 = 'ACGT' * 25 + 'AT' * 75 + 'GGCA' * 25
    spans = [(100, 340), (120, 390), (80, 320), (99, 250), (100, 250)]
    seq, lens = batch_encode([r0, r1, r2, r3, r3], 1024)
    mask = np.zeros(seq.shape, bool)
    for i, (a, b) in enumerate(spans):
        mask[i, a:b] = True
    return seq, lens, mask


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize('backend', ['jax', 'pallas_interpret'])
def test_repeat_mask_planted_batch_zero_mismatches(backend):
    seq, lens = _planted()
    want = np.asarray(jtan.repeat_mask(seq, lens, CFG, backend=backend))
    got = ttan.repeat_mask(*_t(seq, lens), TCFG).numpy()
    assert want.sum() > 500
    assert int((want != got).sum()) == 0


def test_repeat_mask_random_reads_and_long_bucket():
    rng = np.random.default_rng(3)
    flank = decode(random_seq(rng, 300))
    reads = [flank + 'ATTGGC' * 50 + decode(random_seq(rng, 500)),
             decode(random_seq(rng, 1500)), 'ACGTN' * 10]
    seq, lens = batch_encode(reads, 1536)
    want = np.asarray(jtan.repeat_mask(seq, lens, CFG, backend='jax'))
    got = ttan.repeat_mask(*_t(seq, lens), TCFG).numpy()
    np.testing.assert_array_equal(want, got)


def test_posterior_is_a_probability():
    seq, _ = _planted(B=6)
    post = ttan.repeat_posterior(torch.from_numpy(seq), TCFG)
    assert post.shape == (6, 512) and post.dtype == torch.float32
    assert float(post.min()) >= 0.0 and float(post.max()) <= 1.0 + 1e-6


def test_junk_gates_match_jax():
    seq, lens, mask = _blocks_batch()
    want = np.asarray(jks.junk_gates(seq, lens, mask, CFG))
    got = tks.junk_gates(*_t(seq, lens, mask), TCFG).numpy()
    np.testing.assert_array_equal(want, got)
    assert want.any() and not want.all()


def test_junk_blocks_match_jax():
    seq, lens, mask = _blocks_batch()
    jj, (blen, tel, rep, bid, bstart) = jks.junk_blocks_debug(
        seq, lens, mask, CFG)
    tj, (tblen, ttel, trep, tbid, tbstart) = tks.junk_blocks_debug(
        *_t(seq, lens, mask), TCFG)
    np.testing.assert_array_equal(np.asarray(jj), tj.numpy())
    assert np.asarray(jj).tolist() == [False, True, False, True, False]
    live = np.asarray(blen) > 0
    np.testing.assert_array_equal(np.asarray(blen), tblen.numpy())
    np.testing.assert_array_equal(np.asarray(bid)[live], tbid.numpy()[live])
    np.testing.assert_array_equal(np.asarray(bstart)[live],
                                  tbstart.numpy()[live])
    np.testing.assert_allclose(np.asarray(tel)[live], ttel.numpy()[live],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rep)[live], trep.numpy()[live],
                               rtol=0, atol=1e-5)


def test_junk_on_planted_masks_match_jax():
    seq, lens = _planted()
    mask = np.asarray(jtan.repeat_mask(seq, lens, CFG, backend='jax'))
    np.testing.assert_array_equal(
        np.asarray(jks.junk_gates(seq, lens, mask, CFG)),
        tks.junk_gates(*_t(seq, lens, mask), TCFG).numpy())
    np.testing.assert_array_equal(
        np.asarray(jks.junk_blocks(seq, lens, mask, CFG)),
        tks.junk_blocks(*_t(seq, lens, mask), TCFG).numpy())


def test_telomere_tables_match_jax():
    np.testing.assert_array_equal(jks.telomere_table(6),
                                  tks.telomere_table(6))
    assert jks.telomere_codes(6) == tks.telomere_codes(6)
    assert jks.tel_rotations() == tks.tel_rotations()
