"""The card's machine has no jax, pandas or click: the port and
chip_smoke.py must import none of them, and the slice must run with all
three blocked."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ('jax', 'pandas', 'click')


def _port_files():
    out = [os.path.join(REPO, 'chip_smoke.py')]
    for d, _, files in os.walk(os.path.join(REPO, 'fslr_tpu_torch')):
        out += [os.path.join(d, f) for f in files if f.endswith('.py')]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split('.')[0] in BLOCKED]
    assert not bad, bad


_SLICE = r'''
import os, sys
for name in ('jax', 'pandas', 'click'):
    sys.modules[name] = None          # any import of them now fails
import torch
from __graft_entry__ import write_tiny_dataset
from fslr_tpu.config import PipelineConfig
from fslr_tpu_torch.pipeline import run_pipeline

root = sys.argv[1]
ref, fq = write_tiny_dataset(root)
config = PipelineConfig(name='D', out=os.path.join(root, 'out'), ref=ref,
                        primers=('21q1', '17p6'), basecalled=fq,
                        skip_clustering=True, exact_cigars=False)
run_pipeline(config, torch.device('cpu'))
base = os.path.join(root, 'out', 'D')
for suffix in ('.bwa_dodi.bam', '.bwa_dodi.bam.bai', '.mappings.bed',
               '.filter_counts_summary.csv', '.timings.json',
               '.without_primers.fq'):
    assert os.path.exists(base + suffix), suffix
lines = open(base + '.filter_counts_summary.csv').read().splitlines()
counts = dict(zip(lines[1].split(','), lines[2].split(',')))
assert counts['total_kept'] == '5' and counts['junk_seqs_dropped'] == '1'
print('SLICE_OK', len(open(base + '.mappings.bed').readlines()))
'''


def test_slice_runs_with_jax_pandas_click_blocked(tmp_path):
    res = subprocess.run([sys.executable, '-c', _SLICE, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert 'SLICE_OK' in res.stdout
    assert int(res.stdout.split('SLICE_OK')[1]) > 1      # header + rows


_CLI = r'''
import os, sys
for name in ('jax', 'pandas', 'click'):
    sys.modules[name] = None          # any import of them now fails
from __graft_entry__ import write_tiny_dataset
from fslr_tpu_torch import cli

root = sys.argv[1]
ref, fq = write_tiny_dataset(root)
out = os.path.join(root, 'out')
cli.main(['--name', 'D', '--out', out, '--ref', ref, '--primers',
          '21q1,17p6', '--basecalled', fq, '--skip-clustering',
          '--device', 'cpu'])
from fslr_tpu.io.bam import read_bam
_, _, records = read_bam(os.path.join(out, 'D.bwa_dodi.bam'))
assert records
print('CLI_OK', len(open(os.path.join(out, 'D.mappings.bed')).readlines()))
'''


def test_cli_runs_with_jax_pandas_click_blocked(tmp_path):
    """The CLI with exact CIGARs (its default) needs none of the three."""
    res = subprocess.run([sys.executable, '-c', _CLI, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split('CLI_OK')[1]) > 1      # header + rows


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card: non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    res = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the repo, the script cannot run."""
    import shutil
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
