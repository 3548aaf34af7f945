"""The port's parallel layer on the CPU (fslr_tpu_torch/parallel/): the
launch device of a kernel, dp_call on a mesh of four CPU entries against
the plain call, and run_pipeline over a mesh and with skip_alignment
against fslr_tpu's runs and the port's plain run (procs:
tests/test_torch_procs.py)."""

import contextlib
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from fslr_tpu.config import PipelineConfig as JaxPipelineConfig
from fslr_tpu.pipeline import run_pipeline as jax_run_pipeline
from fslr_tpu_torch import kernels
from fslr_tpu_torch.config import (JunkFilterConfig, PipelineConfig,
                                   ScoringConfig)
from fslr_tpu_torch.ops import ssw
from fslr_tpu_torch.parallel import dispatch
from fslr_tpu_torch.parallel.mesh import Mesh, make_mesh
from fslr_tpu_torch.pipeline import run_pipeline
from fslr_tpu_torch.stages import filter_junk
from tests.test_torch_pipeline_cluster import _consensus_files

CPU = torch.device('cpu')
MESH4 = make_mesh(4, 'cpu')
ARTIFACTS = ('.mappings.bed', '.mappings.cluster.bed',
             '.mappings.representative.bed', '.filter_counts_summary.csv',
             '.without_primers.fq', '.bwa_dodi.bam', '.bwa_dodi.bam.bai')


def _read(path):
    with open(path, 'rb') as fh:
        return fh.read()


# ---------------------------------------------------------------------------
# Kernel.launch: the device of its arguments
# ---------------------------------------------------------------------------

class _OnCard1(torch.Tensor):
    """A CPU tensor that reports the device cuda:1 (no card is needed to
    see which device a launch enters)."""

    @property
    def device(self):
        return torch.device('cuda', 1)


def test_launch_enters_the_arguments_device(monkeypatch):
    """Kernel.launch of a cuda:1 argument runs its C entry with device 1
    current and passes device 1's stream, whichever device the calling
    thread has current (here 0)."""
    current = [0]
    calls = []

    @contextlib.contextmanager
    def device(d):
        current.append(torch.device(d).index)
        try:
            yield
        finally:
            current.pop()

    class Stream:
        def __init__(self, index):
            self.cuda_stream = 1000 + index

    def current_stream(d=None):
        return Stream(current[-1] if d is None else torch.device(d).index)

    class Lib:
        def __getattr__(self, symbol):
            def entry(*args):
                calls.append((symbol, current[-1], args))
                return 0
            return entry

    monkeypatch.setattr(kernels, 'library', Lib)
    monkeypatch.setattr(torch.cuda, 'device', device)
    monkeypatch.setattr(torch.cuda, 'current_stream', current_stream)
    x = torch.zeros(8).as_subclass(_OnCard1)
    kernels.reset_launches()
    kernels.WALK.launch(x, x, x, x, 5, 7, x, x)
    p = x.data_ptr()
    assert calls == [('fslr_walk', 1, (p, p, p, p, 5, 7, p, p, 1001))]
    assert kernels.launch_counts()['walk_kernel'] == 1


def test_launch_counts_from_several_threads(monkeypatch):
    monkeypatch.setattr(kernels, 'library',
                        lambda: type('Lib', (), {
                            '__getattr__': lambda self, s: lambda *a: 0})())
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda d=None: type('S', (), {'cuda_stream': 0}))
    x = torch.zeros(1).as_subclass(_OnCard1)
    kernels.reset_launches()

    def launch_many():
        for _ in range(2000):
            kernels.SW.launch(x)

    threads = [threading.Thread(target=launch_many) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert kernels.launch_counts()['sw_kernel'] == 16000
    kernels.reset_launches()


# ---------------------------------------------------------------------------
# dp_call
# ---------------------------------------------------------------------------

def _sw_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, (n, 128)).astype(np.uint8)
    t = rng.integers(0, 5, (n, 300)).astype(np.uint8)
    t[::2, 40:80] = q[::2, :40]
    qlens = rng.integers(0, 129, n).astype(np.int32)
    tlens = rng.integers(0, 301, n).astype(np.int32)
    return [torch.from_numpy(a) for a in (q, t, qlens, tlens)]


def _calls(n):
    """name -> (fn, batch args, statics) of functions the stages shard:
    dict, tuple and pair-of-tensor outputs."""
    q, t, qlens, tlens = _sw_inputs(n)
    rng = np.random.default_rng(1)
    seq = torch.from_numpy(rng.integers(0, 5, (n, 512)).astype(np.uint8))
    seq[:, 100:300] = torch.from_numpy(np.tile(
        np.array([0, 1, 1, 2], np.uint8), 50))
    lens = torch.from_numpy(rng.integers(200, 513, n).astype(np.int32))
    return {
        'sw_locate': (ssw.sw_locate, (q, t, qlens, tlens),
                      (ScoringConfig(),)),
        'sw_max_packed': (ssw.sw_max_packed, (q, t, tlens),
                          (ScoringConfig(), 32)),
        'mask_gate': (filter_junk._mask_gate_packed, (seq, lens),
                      (JunkFilterConfig(),)),
    }


def _equal(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, tuple):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize('n', [1, 3, 9])
@pytest.mark.parametrize('name', ['sw_locate', 'sw_max_packed', 'mask_gate'])
def test_dp_call_equals_the_plain_call(name, n):
    """Four CPU entries, row counts below, at and above the mesh size (the
    last row repeated as padding): every output leaf equals the plain
    call's."""
    fn, batch, statics = _calls(n)[name]
    want = fn(*batch, *statics)
    with dispatch.use_mesh(MESH4):
        got = dispatch.dp_call(fn, batch, statics=statics)
    _equal(got, want)


@pytest.mark.parametrize('n', [1, 3, 9])
def test_dp_call_gathers_along_out_dims(n):
    """Outputs whose batch is not on axis 0 (the align stage's seed and
    score outputs): each leaf gathered along its own axis."""
    x = torch.from_numpy(np.random.default_rng(n).integers(
        0, 100, (n, 4, 3)))

    def fn(x):
        return x.permute(1, 2, 0) * 2, x.permute(1, 0, 2) + 1, x[:, 0]
    want = fn(x)
    with dispatch.use_mesh(MESH4):
        got = dispatch.dp_call(fn, (x,), out_dims=(2, 1, 0))
    _equal(got, want)


def test_dp_call_replicates_tables_once_per_device():
    """A replicated table reaches every shard whole; a device the mesh
    names four times holds one copy, the table itself; the copies go
    with the table."""
    table = torch.arange(100, dtype=torch.int64) * 3
    rows = torch.tensor([5, 99, 0, 42, 7], dtype=torch.int64)
    with dispatch.use_mesh(MESH4):
        got = dispatch.dp_call(lambda r, tab: tab[r], (rows,), (table,))
        assert all(r is table for r in dispatch.replicas(table))
        assert len(dispatch._REPLICAS) == 1
        del table
        assert not dispatch._REPLICAS
    assert torch.equal(got, rows * 3)


def test_no_mesh_and_a_mesh_of_one_call_directly():
    seen = []

    def fn(x):
        seen.append(x)
        return x
    x = torch.zeros(3)
    for mesh in (None, Mesh((CPU,))):
        with dispatch.use_mesh(mesh):
            assert dispatch.dp_call(fn, (x,)) is x
    assert seen == [x, x]


# ---------------------------------------------------------------------------
# run_pipeline over a mesh
# ---------------------------------------------------------------------------

def _config(pkg, out, ref, fq, **kw):
    cls = JaxPipelineConfig if pkg == 'jax' else PipelineConfig
    return cls(name='P', out=out, ref=ref, primers=('21q1', '17p6'),
               basecalled=fq, **kw)


@pytest.fixture(scope='module')
def mesh_runs(tmp_path_factory):
    """fslr_tpu's tiny scenario (tests/test_parallel.py): fslr_tpu on its
    8-device CPU mesh, the port plain and on four CPU entries."""
    from fslr_tpu.parallel.mesh import make_mesh as jax_make_mesh
    root = str(tmp_path_factory.mktemp('mesh'))
    ref, fq = graft.write_tiny_dataset(root)
    outs = {tag: os.path.join(root, tag)
            for tag in ('jax_mesh8', 'torch', 'torch_mesh4')}
    jax_run_pipeline(_config('jax', outs['jax_mesh8'], ref, fq),
                     backend='jax', mesh=jax_make_mesh(8))
    run_pipeline(_config('torch', outs['torch'], ref, fq), CPU)
    run_pipeline(_config('torch', outs['torch_mesh4'], ref, fq), CPU,
                 mesh=MESH4)
    return dict(outs, ref=ref, fq=fq)


@pytest.mark.parametrize('suffix', ARTIFACTS)
def test_mesh_run_byte_equal(mesh_runs, suffix):
    got = _read(os.path.join(mesh_runs['torch_mesh4'], 'P' + suffix))
    assert got == _read(os.path.join(mesh_runs['torch'], 'P' + suffix))
    assert got == _read(os.path.join(mesh_runs['jax_mesh8'], 'P' + suffix))
    if suffix.startswith('.mappings.'):
        assert got.count(b'\n') > 1


# ---------------------------------------------------------------------------
# skip_alignment
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def skip_alignment_runs(mesh_runs):
    """Each package clusters (with and without consensus) from the
    mappings.bed and BAM of its own mesh run, with skip_alignment."""
    bases = {}
    for pkg, src in (('jax', mesh_runs['jax_mesh8']),
                     ('torch', mesh_runs['torch'])):
        for tag, kw in (('cluster', {}),
                        ('consensus', dict(run_consensus=True))):
            out = f'{src}_skip_{tag}'
            os.makedirs(out)
            for suffix in ('.mappings.bed', '.bwa_dodi.bam'):
                shutil.copy(os.path.join(src, 'P' + suffix), out)
            cfg = _config(pkg, out, mesh_runs['ref'], mesh_runs['fq'],
                          skip_alignment=True, **kw)
            if pkg == 'jax':
                jax_run_pipeline(cfg, backend='jax')
            else:
                run_pipeline(cfg, CPU)
            bases[f'{pkg}_{tag}'] = os.path.join(out, 'P')
    return bases


@pytest.mark.parametrize('tag', ['cluster', 'consensus'])
def test_skip_alignment_byte_equal_to_fslr_tpu(skip_alignment_runs,
                                               mesh_runs, tag):
    """Cluster beds (and the consensus stage's files) byte-equal to
    fslr_tpu's; the cluster beds also equal the full run's."""
    tbase = skip_alignment_runs[f'torch_{tag}']
    jbase = skip_alignment_runs[f'jax_{tag}']
    names = ['P.mappings.cluster.bed', 'P.mappings.representative.bed']
    for rel in names:
        assert _read(os.path.join(os.path.dirname(tbase), rel)) == \
            _read(os.path.join(mesh_runs['torch'], rel)), rel
    if tag == 'consensus':
        names += _consensus_files(tbase)
        assert _consensus_files(tbase) == _consensus_files(jbase)
        assert 'cluster/P.cluster.consensus.fa' in names
    for rel in names:
        got = _read(os.path.join(os.path.dirname(tbase), rel))
        assert got == _read(os.path.join(os.path.dirname(jbase), rel)), rel
        assert got.count(b'\n') > 1, rel

