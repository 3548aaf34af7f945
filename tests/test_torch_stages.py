"""fslr_tpu_torch filter and primer stages against fslr_tpu on the CPU:
flags, masks and counters equal; output FASTQ files byte-equal."""

import os
import shutil

import numpy as np
import pytest
import torch

from fslr_tpu.config import JunkFilterConfig, PipelineConfig
from fslr_tpu.encode import decode, encode, revcomp_str
from fslr_tpu.io.fastq import read_reads
from fslr_tpu.panel import load_panel
from fslr_tpu.stages import filter_junk as jfj
from fslr_tpu.stages import find_primers as jfp
from fslr_tpu_torch.io.fastq import read_reads as t_read_reads
from fslr_tpu_torch.io.fastq import records_to_arrays
from fslr_tpu_torch.panel import load_panel as t_load_panel
from fslr_tpu_torch.stages import filter_junk as tfj
from fslr_tpu_torch.stages import find_primers as tfp
from tests.oracles import mutate, random_seq
from tests.test_torch_env import port_config

CPU = torch.device('cpu')
PANEL = load_panel().subset(['21q1', '17p6'])
TPANEL = t_load_panel().subset(['21q1', '17p6'])


def _fastq(path, reads):
    with open(path, 'w') as fh:
        for name, seq in reads:
            fh.write(f'@{name}\n{seq}\n+\n{"I" * len(seq)}\n')


def _filter_reads(rng):
    def r(n):
        return decode(random_seq(rng, n))
    t21 = PANEL.targets['21q1']
    p17 = PANEL.seqs['17p6']
    return [
        ('fusion0', t21 + r(1500) + revcomp_str(PANEL.targets['17p6'])),
        ('fusion1', r(900) + decode(mutate(rng, random_seq(rng, 900)))),
        ('junk', r(300) + 'AT' * 200 + r(300)),
        ('telomeric', r(300) + 'TTAGGG' * 40 + r(300)),
        ('short', r(150)),
        ('no_interior', r(199)),
        ('concat_fwd', r(500) + PANEL.seqs['21q1'] + r(500)),
        ('concat_rc', r(400) + revcomp_str(p17) + r(600)),
        ('concat_in_end_trim', r(40) + p17 + r(500)),
        ('long_multiwindow', r(1700) + p17 + r(400)),
        ('long_clean', r(2500)),
        ('with_n', r(400) + 'N' * 30 + r(400)),
    ]


@pytest.fixture(scope='module')
def filter_case(tmp_path_factory):
    root = tmp_path_factory.mktemp('filter')
    path = os.path.join(root, 'in.fastq')
    _fastq(path, _filter_reads(np.random.default_rng(11)))
    # a 600 bp concatemer chunk exercises the multi-window walk
    config = PipelineConfig(name='F', out=str(root),
                            junk=JunkFilterConfig(chunk_size=600))
    return path, config


def test_filter_junk_records_match(filter_case):
    path, config = filter_case
    want = jfj.filter_junk_records(read_reads(path), PANEL, config,
                                   backend='jax')
    got = tfj.filter_junk_records(t_read_reads(path), TPANEL,
                                  port_config(config), CPU)
    for name, a, b in zip(('keep', 'flat_mask', 'junk', 'short', 'concat'),
                          want[:5], got[:5]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert dict(want[5]) == dict(got[5])
    keep, _, junk, short, concat, counters = got
    assert junk.any() and short.any() and concat.any() and keep.any()
    assert counters['concatemers_dropped'] >= 3


def test_filter_run_file_outputs_match(filter_case, tmp_path):
    path, config = filter_case
    outs = {}
    for tag in ('jax', 'torch'):
        cfg = config.replace(out=str(tmp_path / tag), keep_temp=True)
        os.makedirs(cfg.out)
        box: dict = {}
        if tag == 'jax':
            c = jfj.run_file(path, PANEL, cfg, backend='jax', out_box=box)
        else:
            c = tfj.run_file(path, TPANEL, port_config(cfg), CPU,
                             out_box=box)
        with open(box['path'], 'rb') as fh:
            kept = fh.read()
        with open(box['path'].replace('.filtered_junk.fq', '.junk.fq'),
                  'rb') as fh:
            dropped = fh.read()
        outs[tag] = (c, kept, dropped, box['reads'].n)
    assert outs['jax'] == outs['torch']
    assert b'_junk' in outs['torch'][2] and b'_concatemer' in outs['torch'][2]


def _primer_reads(rng):
    def r(n):
        return decode(random_seq(rng, n))
    t21 = PANEL.targets['21q1']
    t17 = PANEL.targets['17p6']
    reads = [
        ('both', r(3) + t21 + r(900) + revcomp_str(t17) + r(2)),
        ('both_rev', revcomp_str(t21) + r(700) + t17),
        ('left_only', t21 + r(800)),
        ('right_only', r(800) + revcomp_str(t21)),
        ('none', r(900)),
        ('mutated', decode(mutate(rng, encode(t21), sub=0.06)) + r(600)),
        ('noisy_primers', decode(mutate(rng, encode(t17), sub=0.1))
         + r(650) + decode(mutate(rng, encode(revcomp_str(t21)), sub=0.1))),
        ('short_read', t21[:40] + r(30)),
    ]
    # lowercase (repeat-masked) stretches ride through the trim
    return [(n, s[:100] + s[100:160].lower() + s[160:]) for n, s in reads]


def test_find_primers_run_file_match(tmp_path):
    src = tmp_path / 'reads.fa'
    with open(src, 'w') as fh:
        for name, seq in _primer_reads(np.random.default_rng(12)):
            fh.write(f'>{name} comment={name}\n{seq}\n')
    config = PipelineConfig(name='P', out=str(tmp_path))
    results = {}
    for tag in ('jax', 'torch'):
        d = tmp_path / tag
        d.mkdir()
        path = str(d / 'reads.fa')
        shutil.copy(src, path)
        if tag == 'jax':
            c = jfp.run_file(path, PANEL, config, backend='jax')
        else:
            c = tfp.run_file(path, TPANEL, port_config(config), CPU)
        files = {}
        for suffix in ('.primers_labelled.fq', '.no_primers.fq'):
            with open(str(d / 'reads') + suffix, 'rb') as fh:
                files[suffix] = fh.read()
        results[tag] = (c, files)
    assert results['jax'] == results['torch']
    counters, files = results['torch']
    assert counters['trimmed_reads'] > 0
    assert files['.primers_labelled.fq'] and files['.no_primers.fq']


def test_label_and_chop_empty_input():
    records, has_primer, counters = tfp.label_and_chop(
        records_to_arrays([]), TPANEL, port_config(PipelineConfig()), CPU)
    assert records == [] and len(has_primer) == 0
    assert counters['starting_bases'] == 0
