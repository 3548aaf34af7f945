"""``procs``: input files filtered and primer-searched on host threads.
Four input files on four threads give fslr_tpu's ``procs=4`` artifacts
and the port's one-thread artifacts: beds, counts and
without_primers.fq byte-equal, the BAM's records equal."""

import gzip
import os

import numpy as np
import pytest
import torch

from fslr_tpu.config import PipelineConfig as JaxPipelineConfig
from fslr_tpu.pipeline import run_pipeline as jax_run_pipeline
from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.encode import decode, revcomp_str
from fslr_tpu_torch.io import bam as bamio
from fslr_tpu_torch.panel import load_panel
from fslr_tpu_torch.pipeline import run_pipeline
from tests.oracles import random_seq

CPU = torch.device('cpu')
BYTE_EQUAL = ('.mappings.bed', '.mappings.cluster.bed',
              '.mappings.representative.bed', '.filter_counts_summary.csv',
              '.without_primers.fq')


def _read(path):
    with open(path, 'rb') as fh:
        return fh.read()


def _short_dataset(root):
    """tests/test_multiprocess.py's four input files with reads of ~0.9 kb
    (their three segments cut to 250, 300 and 250 bp): the plain repeat
    mask's steps, on host threads, set this test's time.  The first file
    also holds two reads without primers, so that without_primers.fq has
    records, all from one file (the files' filtered copies have random
    names, which order the concatenation)."""
    rng = np.random.default_rng(5)
    chrA = random_seq(rng, 400_000)
    ref = os.path.join(root, 'ref.fa')
    with open(ref, 'w') as fh:
        fh.write('>chrA\n' + decode(chrA) + '\n')
    panel = load_panel().subset(['21q1', '17p6'])
    t21, t17rc = panel.targets['21q1'], revcomp_str(panel.targets['17p6'])
    fq = os.path.join(root, 'reads')
    os.makedirs(fq)
    for f in range(4):
        b = 200_000 + (f % 2) * 50_000
        seq = (t21 + decode(chrA[100_000:100_250]) + decode(chrA[b:b + 300])
               + decode(chrA[150_000:150_250]) + t17rc)
        with open(os.path.join(fq, f'b{f}.fastq'), 'w') as fh:
            for i in range(5):
                fh.write(f'@f{f}r{i}\n{seq}\n+\n{"I" * len(seq)}\n')
            for i in range(2 if f == 0 else 0):
                bare = decode(chrA[300_000 + i * 20_000:300_900 + i * 20_000])
                fh.write(f'@f{f}bare{i}\n{bare}\n+\n{"I" * len(bare)}\n')
    return ref, fq


@pytest.fixture(scope='module')
def procs_runs(tmp_path_factory):
    """The port with procs 1 and 4, fslr_tpu with procs 4."""
    root = str(tmp_path_factory.mktemp('procs'))
    ref, fq = _short_dataset(root)
    bases = {}
    for tag, cls, procs in (('torch1', PipelineConfig, 1),
                            ('torch4', PipelineConfig, 4),
                            ('jax4', JaxPipelineConfig, 4)):
        out = os.path.join(root, tag)
        cfg = cls(name='M', out=out, ref=ref, primers=('21q1', '17p6'),
                  basecalled=fq, procs=procs, exact_cigars=False)
        if cls is PipelineConfig:
            run_pipeline(cfg, CPU)
        else:
            jax_run_pipeline(cfg, backend='jax')
        bases[tag] = os.path.join(out, 'M')
    return bases


@pytest.mark.parametrize('suffix', BYTE_EQUAL)
def test_procs_byte_equal(procs_runs, suffix):
    got = _read(procs_runs['torch4'] + suffix)
    assert got == _read(procs_runs['jax4'] + suffix), 'fslr_tpu procs=4'
    assert got == _read(procs_runs['torch1'] + suffix), 'port procs=1'
    assert got.count(b'\n') > 1


def _bam_record_set(path):
    names, lengths, recs = bamio.read_bam(path)
    return names, lengths, sorted(
        (r.qname, r.flag, r.ref_id, r.pos, str(r.cigar), r.seq,
         sorted(r.tags.items())) for r in recs)


def test_procs_bam_records(procs_runs):
    """The BAM's records equal as a multiset (reads of equal sequence
    from different files tie on coordinates; the files' random names
    order them)."""
    got = _bam_record_set(procs_runs['torch4'] + '.bwa_dodi.bam')
    assert got == _bam_record_set(procs_runs['jax4'] + '.bwa_dodi.bam')
    assert got == _bam_record_set(procs_runs['torch1'] + '.bwa_dodi.bam')
    assert len(got[2]) > 10
    assert gzip.decompress(
        _read(procs_runs['torch4'] + '.bwa_dodi.bam'))[:4] == b'BAM\x01'
