"""The multi-card path's host side on the CPU, with faked cards: the mesh
the CLI builds from ``--device cuda:i``, the kernels' launch counts by
card, the stage timer waiting for every card of the mesh, the profile DP
sharded over a mesh (against fslr_tpu's profile_align_walk), and
chip_smoke.py's pinning of its one-card runs to one card and of each
process to its own card.  The paths on real cards: tests/test_torch_cuda.py
(two cards or more) and ``python3 chip_smoke.py --cards N``."""

import contextlib
import json
import os
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from fslr_tpu.ops import profile_align as jpa
from fslr_tpu_torch import cli, kernels, pipeline
from fslr_tpu_torch.ops import profile_align as tpa
from fslr_tpu_torch.parallel import dispatch
from fslr_tpu_torch.parallel.mesh import Mesh, make_mesh
from tests.test_torch_env import port_config
from tests.test_torch_profile_align import SC, _rows


def _cuda(i):
    return torch.device('cuda', i)


@pytest.mark.parametrize('argv,want', [
    (['--device', 'cuda:2'], (2, 0, 1, 3)),
    (['--device', 'cuda:2', '--mesh-devices', '0'], (2, 0, 1, 3)),
    (['--device', 'cuda:2', '--mesh-devices', '2'], (2, 0)),
    (['--device', 'cuda:0', '--mesh-devices', '9'], (0, 1, 2, 3)),
    (['--device', 'cuda:2', '--mesh-devices', '1'], None),
], ids=['default', 'zero', 'two', 'more_than_visible', 'one'])
def test_mesh_from_args_on_four_cards(monkeypatch, argv, want):
    """With four visible cards the CLI meshes --device's card first, then
    the others in order; --mesh-devices 1 gives no mesh."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    args = cli._parser().parse_args(['--name', 'S', '--out', 'o', '--ref',
                                     'r', '--primers', 'p', *argv])
    mesh = cli.mesh_from_args(args, torch.device(args.device))
    assert mesh == (Mesh(tuple(_cuda(i) for i in want)) if want else None)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports the card ``card`` (set on the class)."""
    card = 0

    @property
    def device(self):
        return _cuda(self.card)


def _fake_library(monkeypatch):
    """Kernel.launch with a stubbed library, device switch and stream."""
    monkeypatch.setattr(kernels, 'library',
                        lambda: type('Lib', (), {
                            '__getattr__': lambda self, s: lambda *a: 0})())
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda d=None: type('S', (), {'cuda_stream': 0}))


def test_launch_counts_by_card(monkeypatch):
    """Each launch counts once in all and once on the card of its first
    tensor argument; reset_launches clears both."""
    _fake_library(monkeypatch)
    on = {i: torch.zeros(1).as_subclass(type(f'On{i}', (_OnCard,),
                                             {'card': i}))
          for i in (1, 3)}
    kernels.reset_launches()
    kernels.SW.launch(on[1])
    kernels.SW.launch(on[3])
    kernels.SW.launch(on[1])
    kernels.MASK.launch(on[3])
    assert kernels.launch_counts()['sw_kernel'] == 3
    by = kernels.launch_counts(by_device=True)
    assert by['sw_kernel'] == {1: 2, 3: 1}
    assert by['mask_kernel'] == {3: 1}
    assert by['prof_kernel'] == {}
    kernels.reset_launches()
    assert kernels.launch_counts(by_device=True)['sw_kernel'] == {}
    assert kernels.launch_counts()['sw_kernel'] == 0


@pytest.mark.parametrize('mesh,device,want', [
    ((0, 1, 2, 3), 0, [0, 1, 2, 3]),
    ((2, 0, 1, 3), 2, [2, 0, 1, 3]),
    ((0, 0), 0, [0]),
    (None, 1, [1]),
], ids=['four', 'four_from_2', 'one_card_twice', 'no_mesh'])
def test_stage_waits_for_every_card_of_the_mesh(monkeypatch, mesh, device,
                                                want):
    """A stage's clock stops after the run's card and every other card of
    the active mesh have finished their work, each card once."""
    seen = []
    monkeypatch.setattr(torch.cuda, 'synchronize',
                        lambda d=None: seen.append(torch.device(d).index))
    with dispatch.use_mesh(Mesh(tuple(_cuda(i) for i in mesh))
                           if mesh else None):
        pipeline._synchronize(_cuda(device))
    assert seen == want


def test_stage_on_the_cpu_waits_for_no_card(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, 'synchronize', seen.append)
    with dispatch.use_mesh(make_mesh(4, 'cpu')):
        pipeline._synchronize(torch.device('cpu'))
    assert seen == []


def test_dp_call_queues_every_shard_from_the_calling_thread():
    """dp_call runs the shards in mesh order on the calling thread, which
    queues every card's work without waiting for it (a host thread a card
    contended for the interpreter's lock on every torch operation)."""
    seen = []

    def fn(x):
        seen.append((threading.current_thread(), x.tolist()))
        return x * 2
    x = torch.arange(7)
    with dispatch.use_mesh(make_mesh(4, 'cpu')):
        got = dispatch.dp_call(fn, (x,))
    assert seen == [(threading.current_thread(), rows)
                    for rows in ([0, 1], [2, 3], [4, 5], [6, 6])]
    assert torch.equal(got, x * 2)


@pytest.mark.parametrize('seed,N,Lq', [(0, 7, 256), (3, 2, 128)])
def test_profile_align_walk_on_a_mesh_matches_jax(seed, N, Lq):
    """The profile DP and walk cut into row shards over a mesh of four
    entries (7 rows: padding to 8; 2 rows: padding to 4) equal fslr_tpu's
    profile_align_walk (exact, as tests/test_torch_profile_align.py)."""
    q, sp, g, qlens = _rows(seed, N, Lq)
    want = jpa.profile_align_walk(q, sp, g, qlens, SC, backend='jax')
    with dispatch.use_mesh(make_mesh(4, 'cpu')):
        got = tpa.profile_align_walk(
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (q, sp, g, qlens)), port_config(SC))
    for a, b in zip(want[:5], got[:5]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert list(want[5]) == list(got[5])


def test_one_card_runs_of_chip_smoke_pass_mesh_devices_1(monkeypatch,
                                                          tmp_path):
    """chip_smoke's CLI runs of phases 4-8 stay on their one card on a
    host with several (the CLI's default meshes them all)."""
    seen = []
    monkeypatch.setattr(cli, 'main', seen.append)
    chip_smoke._run(str(tmp_path), 'ref.fa', 'fq', 'x', _cuda(0), True)
    argv = seen[0]
    assert argv[argv.index('--mesh-devices') + 1] == '1'
    assert argv[argv.index('--device') + 1] == 'cuda:0'


def test_each_process_gets_its_own_card(monkeypatch, tmp_path):
    """chip_smoke._processes starts one CLI process a device, process i
    with --device devices[i], and sums their launch counts."""
    started = []

    class Proc:
        returncode = 0

        def __init__(self, argv, **_):
            started.append(argv)
            pid = int(argv[argv.index('--process-id') + 1])
            with open(argv[3], 'w') as fh:
                json.dump(dict(
                    launches={k: {str(pid): 1}
                              for k in kernels.launch_counts()},
                    peak_bytes={str(pid): 10}), fh)

        def poll(self):
            return 0

    monkeypatch.setattr(chip_smoke.subprocess, 'Popen', Proc)
    cards = [_cuda(i) for i in range(4)]
    _, launches, per = chip_smoke._processes(['--name', 'C'], 'out',
                                             str(tmp_path), cards)
    for pid, argv in enumerate(started):
        assert argv[argv.index('--device') + 1] == f'cuda:{pid}'
        assert argv[argv.index('--process-id') + 1] == str(pid)
        assert argv[argv.index('--n-processes') + 1] == '4'
    assert launches == dict.fromkeys(chip_smoke.KERNELS, 4)
    assert [p['peak_bytes'] for p in per] == [{str(i): 10} for i in range(4)]
    assert all(os.path.exists(tmp_path / f'launches_p{i}.json')
               for i in range(4))


@pytest.mark.parametrize('n,visible,error', [
    (4, 1, RuntimeError), (4, 3, RuntimeError), (1, 4, ValueError)])
def test_cards_phase_refuses_too_few_cards(monkeypatch, n, visible, error):
    """--cards N raises on a host with fewer than N cards (no fallback to
    fewer), and N must be at least 2."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: visible)
    monkeypatch.setattr(chip_smoke, 'build_kernels',
                        lambda: pytest.fail('built before the check'))
    with pytest.raises(error):
        chip_smoke.main_cards(n, 'NVIDIA H100 80GB HBM3, 700.00 W')


def test_a_failed_process_ends_the_run_at_once(monkeypatch, tmp_path):
    """chip_smoke._processes kills the other processes as soon as one
    fails (they would wait for it until their group's timeout) and names
    the one that failed."""
    procs = []

    class Proc:
        def __init__(self, argv, stdout=None, **_):
            self.pid = int(argv[argv.index('--process-id') + 1])
            self.returncode = 2 if self.pid == 1 else None
            stdout.write(f'log of process {self.pid}'.encode())
            procs.append(self)

        def poll(self):
            return self.returncode

        def kill(self):
            self.returncode = -9

        def wait(self):
            return self.returncode

    monkeypatch.setattr(chip_smoke.subprocess, 'Popen', Proc)
    monkeypatch.setattr(chip_smoke, 'PAR_PROC_TIMEOUT_S', 60)
    with pytest.raises(AssertionError, match='process 1 of 3 exited with 2'
                       ':\nlog of process 1'):
        chip_smoke._processes(['--name', 'C'], 'out', str(tmp_path),
                              [_cuda(i) for i in range(3)])
    assert [p.returncode for p in procs] == [-9, 2, -9]
