"""Multi-process runs of the port on the CPU: two OS processes joined by
torch.distributed (gloo) give the artifacts of one process, as
tests/test_multiprocess.py holds fslr_tpu's, on its dataset (four input
files): beds and filter counts byte-equal, BAM records equal as a
multiset.  Each process may run a 4-entry CPU mesh; a forced skew with an
ownership spy checks that a process touches only its own intermediates.
The runs take approximate CIGARs (``exact_cigars=False``), the quicker
align on the CPU; the merge of the processes' parts does not depend on
it.

Every child process has at most TIMEOUT seconds and a process group
waits at most GROUP_TIMEOUT seconds for a peer, so a hung peer fails the
test instead of running the suite into its limit."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from fslr_tpu.config import PipelineConfig as JaxPipelineConfig
from fslr_tpu.pipeline import run_pipeline as jax_run_pipeline
from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.io import bam as bamio
from fslr_tpu_torch.pipeline import run_pipeline
from tests.test_multiprocess import _make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180
GROUP_TIMEOUT = 120
BEDS = ('mappings.bed', 'mappings.cluster.bed',
        'mappings.representative.bed', 'filter_counts_summary.csv')

_RUNNER = textwrap.dedent('''
    import os, sys, time
    time.sleep({delay})
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(2)
    from fslr_tpu_torch.config import PipelineConfig
    from fslr_tpu_torch.parallel import distributed
    from fslr_tpu_torch.parallel.mesh import make_mesh
    from fslr_tpu_torch.pipeline import run_pipeline
    from fslr_tpu_torch.stages import find_primers

    # ownership spy: every intermediate this process consumes carries its
    # own process tag
    _run_file = find_primers.run_file
    def _spy(path, *a, **kw):
        assert '__p{pid}.' in os.path.basename(path), (
            'process {pid} consumed foreign intermediate: ' + path)
        return _run_file(path, *a, **kw)
    find_primers.run_file = _spy

    distributed.TIMEOUT_S = {group_timeout}
    cfg = PipelineConfig(
        name='M', out={out!r}, ref={ref!r}, primers=('21q1', '17p6'),
        basecalled={fq!r}, n_processes=2, process_id={pid},
        coordinator={coord!r}, exact_cigars=False)
    t0 = time.perf_counter()
    run_pipeline(cfg, torch.device('cpu'),
                 mesh=make_mesh({mesh}, 'cpu') if {mesh} > 1 else None)
    print('wall', time.perf_counter() - t0)
''')


def _config(cls, out, ref, fq):
    return cls(name='M', out=out, ref=ref, primers=('21q1', '17p6'),
               basecalled=fq, exact_cigars=False)


@pytest.fixture(scope='module')
def single(tmp_path_factory):
    """fslr_tpu's and the port's one-process runs of the dataset."""
    root = tmp_path_factory.mktemp('mp')
    ref, fq = _make_dataset(root)
    jax_run_pipeline(_config(JaxPipelineConfig, str(root / 'jax'), ref, fq),
                     backend='jax')
    run_pipeline(_config(PipelineConfig, str(root / 'torch'), ref, fq),
                 torch.device('cpu'))
    with open(root / 'torch' / 'M.timings.json') as fh:
        stages = json.load(fh)['timings_s']
    return dict(root=root, ref=ref, fq=fq,
                stage_s=stages['filter_junk'] + stages['find_primers'])


def _records(path):
    _, _, recs = bamio.read_bam(str(path))
    return sorted((r.qname, r.flag, r.ref_id, r.pos, str(r.cigar), r.seq)
                  for r in recs)


def _run_two(single, tag, mesh=1, delays=(0, 0)):
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    out = single['root'] / tag
    procs = [subprocess.Popen(
        [sys.executable, '-c', _RUNNER.format(
            repo=REPO, out=str(out), ref=single['ref'], fq=single['fq'],
            pid=pid, coord=f'127.0.0.1:{port}', mesh=mesh,
            delay=delays[pid], group_timeout=GROUP_TIMEOUT)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            o, _ = p.communicate()
        outs.append(o.decode(errors='replace'))
    for pid, p in enumerate(procs):
        assert p.returncode == 0, \
            f'process {pid} failed:\n{outs[pid][-4000:]}'
    one = [single['root'] / pkg for pkg in ('torch', 'jax')]
    for art in BEDS:
        got = (out / f'M.{art}').read_bytes()
        for base in one:
            assert got == (base / f'M.{art}').read_bytes(), (art, base)
    want = _records(one[0] / 'M.bwa_dodi.bam')
    assert _records(out / 'M.bwa_dodi.bam') == want and len(want) > 10
    assert want == _records(one[1] / 'M.bwa_dodi.bam')
    # process 0 removed both processes' parts
    assert not [p for p in os.listdir(out) if '__p' in p]
    return outs


def test_two_processes_equal_one(single):
    _run_two(single, 'two')


def test_two_processes_with_four_entry_meshes(single):
    """n_processes=2, each process with a local mesh of four CPU
    entries."""
    _run_two(single, 'two_mesh', mesh=4)


def test_two_processes_forced_skew(single):
    """Process 1 starts later than process 0's whole filter and primer
    stages take (the one-process run's, over all four files), so process
    0 has finished them before process 1 begins: nothing may take or
    delete the late process's files, and the spy in each process fails
    it on a foreign intermediate."""
    delay = round(single['stage_s'] + 2.0, 1)
    print(f'forced skew: process 1 starts {delay} s late (the one-process '
          f"filter + primer stages took {single['stage_s']:.2f} s)")
    _run_two(single, 'skew', delays=(0, delay))
