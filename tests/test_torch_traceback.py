"""fslr_tpu_torch.ops.traceback against fslr_tpu.ops.traceback on the CPU:
the tb pass (against the pure-JAX version and the Pallas kernel in
interpret mode), the path walk, the traceback extension and the emit
decoder.  All integer or integer-valued float32 results: every comparison
is exact."""

import numpy as np
import pytest
import torch

from fslr_tpu.config import ScoringConfig
from fslr_tpu.ops import banded as jband
from fslr_tpu.ops import traceback as jtb
from fslr_tpu_torch.ops import traceback as ttb
from tests.test_torch_env import port_config
from tests.oracles import mutate, random_seq

BWA_SC = ScoringConfig(gap_open_is_first_base=False)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _tb_rows(seed, N=7, Lq=256):
    """Reads against windows holding a mutated copy at a random offset;
    row 3 has qlen 0 and row 4 a qlen that is not a multiple of 8."""
    rng = np.random.default_rng(seed)
    q = np.full((N, Lq), 4, np.uint8)
    w = np.full((N, Lq + 256), 4, np.uint8)
    qlens = np.zeros(N, np.int32)
    for r in range(N):
        read = random_seq(rng, int(rng.integers(30, Lq - 6)))
        seg = read.copy() if r == 0 else mutate(rng, read, sub=0.06,
                                                indel=0.04)
        win = np.concatenate([random_seq(rng, int(rng.integers(0, 100))),
                              seg, random_seq(rng, Lq + 256)])
        q[r, :len(read)] = read
        qlens[r] = len(read)
        w[r] = win[:Lq + 256]
    qlens[3] = 0
    qlens[4] = 77
    return q, w, qlens


@pytest.mark.parametrize('sc', [BWA_SC, ScoringConfig()], ids=['bwa', 'ssw'])
@pytest.mark.parametrize('backend', ['jax', 'pallas_interpret'])
def test_tb_matches(backend, sc):
    q, w, qlens = _tb_rows(0)
    want = jtb.banded_sw_tb(q, w, qlens, sc, backend=backend)
    got = ttb.banded_sw_tb(*_t(q, w, qlens), port_config(sc))
    for name, a, b in zip(('score', 'qend', 'lane', 'bits'), want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    # codes with bit 3 set fill the sign bit of their word, as in JAX
    assert (got[3] < 0).any()


def test_walk_matches_jax_walks():
    q, w, qlens = _tb_rows(1)
    score, qend, lane, bits = (np.asarray(a) for a in jtb.banded_sw_tb(
        q, w, qlens, BWA_SC, backend='jax'))
    # the empty alignment: a row that scored nothing walks from (0, 0)
    assert score[3] == 0 and qend[3] == 0 and lane[3] == 0
    T = bits.shape[1] * 8 + 128
    emits, n_ops, i_fin, l_fin = (a.numpy() for a in ttb._walk_torch(
        *_t(bits, qend, lane), T))
    want = [np.asarray(a) for a in jtb._walk_device(bits, qend, lane, T)]
    for name, a, b in zip(('emits', 'n_ops', 'i_fin', 'l_fin'), want,
                          (emits, n_ops, i_fin, l_fin)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    ops, h_n, h_i, h_l = jtb.walk_paths(bits, qend, lane)
    np.testing.assert_array_equal(h_n, n_ops)
    np.testing.assert_array_equal(h_i, i_fin)
    np.testing.assert_array_equal(h_l, l_fin)
    for r in range(len(q)):
        np.testing.assert_array_equal(emits[r][emits[r] != 255],
                                      ops[r][:h_n[r]])


def test_walk_edge_codes_match_jax_walks():
    """The card tests' walk inputs (chip_smoke.walk_edge_inputs: a score-0
    row, an all-diagonal path down to i = 0, an I run clamped at lane 127,
    a D-heavy path clamped at lane 0, random paths) walk as the JAX
    package walks them."""
    import chip_smoke
    bits, _, qend, lane = chip_smoke.walk_edge_inputs(6, 64)
    T = 64 + 128
    got = ttb._walk_torch(*_t(bits, qend, lane), T)
    want = jtb._walk_device(bits, qend, lane, T)
    for name, a, b in zip(('emits', 'n_ops', 'i_fin', 'l_fin'), want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    assert int(got[1][0]) == 0 and int(got[2][1]) == -1
    assert int(got[3][3]) < 0 and int(got[3][2]) > 127


def test_longest_path_counts_steps_to_the_last_emit():
    """chip_smoke.longest_path reads the walk's serial chain from the
    2-bit packed emits: the last step that emitted an op, plus one."""
    import chip_smoke
    bits, score, qend, lane = _t(*chip_smoke.walk_edge_inputs(6, 64))
    emits, *_ = ttb._walk_torch(bits, qend, lane, 64 + 128)
    _, packed = ttb.walk(bits, score, qend, lane)
    steps = torch.arange(1, emits.shape[1] + 1)
    want = int((steps * (emits != 255)).max())
    assert chip_smoke.longest_path(packed) == want > 64
    assert chip_smoke.longest_path(packed[:1]) == 0
    assert chip_smoke.longest_path(packed[:0]) == 0


def test_launch_shape_of_saved_launches():
    """The row and width summary time_launches prints for a saved launch:
    SW kernels by target width and lengths, the traceback DPs by query
    width and lengths."""
    import chip_smoke
    q = torch.zeros((4, 128), dtype=torch.uint8)
    t = torch.zeros((4, 400), dtype=torch.uint8)
    qlens = torch.tensor([0, 30, 68, 68], dtype=torch.int32)
    tlens = torch.tensor([0, 100, 200, 400], dtype=torch.int32)
    assert chip_smoke.launch_shape('sw_kernel', (q, t, qlens, tlens)) == dict(
        rows=4, T=400, tlen_quartiles=[0, 75, 150, 250, 400], qlen_max=68)
    assert chip_smoke.launch_shape('sw_packed_kernel', (q, t, tlens)) == dict(
        rows=4, T=400, tlen_quartiles=[0, 75, 150, 250, 400])
    q = torch.zeros((3, 256), dtype=torch.uint8)
    qlens = torch.tensor([0, 100, 256], dtype=torch.int32)
    want = dict(rows=3, Lq=256, qlen_quartiles=[0, 50, 100, 178, 256])
    assert chip_smoke.launch_shape('prof_kernel', (q, None, None, qlens)) \
        == want
    assert chip_smoke.launch_shape('tb_kernel', (q, None, qlens)) == want


def test_walk_replays_the_score():
    """The walked path, scored against its own query and window, gives
    the DP score (tests/test_traceback.py's replay)."""
    from tests.test_traceback import _score_from_path
    q, w, qlens = _tb_rows(2)
    score, qend, lane, bits = ttb.banded_sw_tb(*_t(q, w, qlens),
                                               port_config(BWA_SC))
    packed, emits = ttb.walk(bits, score, qend, lane)
    p = packed.numpy()
    cigars = ttb.decode_emit_rows(emits.numpy())
    # a row that scored nothing (row 3) is never selected, so its walk is
    # not replayed
    for r in np.flatnonzero(p[0] > 0):
        qs, lf = int(p[3, r]), int(p[4, r])
        got, qi, ri = _score_from_path(cigars[r], q[r], w[r], qs, qs + lf,
                                       BWA_SC)
        assert got == int(score[r]) == p[0, r], r
        assert qi == int(qend[r]) + 1
        assert ri == int(qend[r]) + int(lane[r]) + 1
    assert (p[0] > 0).sum() == len(q) - 1
    assert cigars[0] == [(int(qlens[0]), 'M')]


@pytest.mark.parametrize('sc', [BWA_SC, ScoringConfig()], ids=['bwa', 'ssw'])
def test_banded_extend_matches(sc):
    rng = np.random.default_rng(3)
    genome = random_seq(rng, 6000, 0.01)
    N, SL = 9, 384
    q = np.full((N, SL), 4, np.uint8)
    qlens = np.zeros(N, np.int32)
    ws = np.zeros(N, np.int32)
    for r in range(N):
        g0 = int(rng.integers(0, 5400))
        read = mutate(rng, genome[g0:g0 + int(rng.integers(40, 370))])[:SL]
        q[r, :len(read)] = read
        qlens[r] = len(read)
        ws[r] = g0 - 64 + int(rng.integers(-20, 20))
    ws[0] = -100                        # window starts before the genome
    qlens[5] = 0
    cmin = np.where(np.arange(N) % 2, 0, 3000).astype(np.int32)
    cmax = np.where(np.arange(N) % 2, 3000, 6000).astype(np.int32)
    want_p, want_e = jtb.banded_extend(q, qlens, ws, cmin, cmax,
                                       jband.pack_codes_host(genome), sc,
                                       backend='jax')
    got_p, got_e = ttb.banded_extend(*_t(q, qlens, ws, cmin, cmax, genome),
                                     port_config(sc))
    assert got_p.shape == (6, N) and got_e.shape == (N, (SL + 128) // 4)
    np.testing.assert_array_equal(np.asarray(want_p), got_p.numpy())
    assert np.asarray(want_e).tobytes() == got_e.numpy().tobytes()
    assert got_e.dtype == torch.uint8


@pytest.mark.parametrize('seed', [0, 1])
def test_decode_emit_rle_matches(seed):
    rng = np.random.default_rng(11 + seed)
    n, t4 = 64, 96
    blocks = rng.integers(0, 256, (n, t4)).astype(np.uint8)
    blocks[5] = 0xff                      # all "none"
    blocks[6, :t4 // 2] = 0xff            # half none
    blocks[7] = 0x00                      # one long M run
    for a, b in zip(jtb.decode_emit_rle(blocks),
                    ttb.decode_emit_rle(blocks)):
        np.testing.assert_array_equal(a, b)
    assert ttb.decode_emit_rows(blocks) == jtb.decode_emit_rows(blocks)
    empty = np.full((3, t4), 0xff, np.uint8)
    assert all(len(a) == 0 for a in ttb.decode_emit_rle(empty))
    assert ttb.decode_emit_rows(empty) == [[], [], []]


def test_cuda_only_shapes_are_checked():
    """The kernels take whole 16-step rows; the plain versions any
    multiple of 8 (the CUDA wrappers raise before any launch)."""
    q, w, qlens = _tb_rows(4, Lq=136)
    with pytest.raises(ValueError, match='multiple of 16'):
        ttb._check_rows(*_t(q, w, qlens))
    want = jtb.banded_sw_tb(q, w, qlens, BWA_SC, backend='jax')
    got = ttb.banded_sw_tb(*_t(q, w, qlens), port_config(BWA_SC))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
