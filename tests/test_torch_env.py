"""The card's machine has no jax, pandas or click, and the port stands
alone: fslr_tpu_torch and chip_smoke.py import none of them, nor the JAX
package, bench.py or __graft_entry__.py, and the slice (with clustering
and consensus) runs with all of them blocked.  The port's copies of the
host modules keep fslr_tpu's defaults, panel and dataset bytes."""

import ast
import dataclasses
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ('jax', 'pandas', 'click', 'fslr_tpu', 'bench', '__graft_entry__')


def port_config(cfg):
    """The fslr_tpu_torch.config twin of a fslr_tpu.config dataclass, with
    the same field values (nested configs converted too)."""
    import fslr_tpu_torch.config as tconfig
    if not dataclasses.is_dataclass(cfg):
        return cfg
    cls = getattr(tconfig, type(cfg).__name__)
    return cls(**{f.name: port_config(getattr(cfg, f.name))
                  for f in dataclasses.fields(cfg)})


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


# what names the JAX package's native/ tree (its prebuilt parser and its
# source) or the switch that once chose the Python parser
NATIVE_TREE = re.compile(r"FSLR_NO_NATIVE|['\"]native['\"]|(?<![\w.])native/"
                         r"|libfslr_native|fslr_native\.cpp")


def _port_sources():
    """Every file of fslr_tpu_torch/ with code in it, and chip_smoke.py."""
    out = [os.path.join(REPO, 'chip_smoke.py')]
    for d, _, files in os.walk(os.path.join(REPO, 'fslr_tpu_torch')):
        out += [os.path.join(d, f) for f in files
                if f.endswith(('.py', '.cu', '.cuh', '.cpp'))]
    return sorted(out)


@pytest.mark.parametrize('path', _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_names_no_native_tree(path):
    """The port owns its parser (csrc/fastx.cpp): no file of it reaches
    into native/ or keeps the switch to a fallback parser."""
    with open(path) as fh:
        bad = [f'{i}: {ln.strip()}' for i, ln in enumerate(fh, 1)
               if NATIVE_TREE.search(ln)]
    assert not bad, bad


_BLOCK = f'''
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None          # any import of them now fails
'''

_SLICE = _BLOCK + r'''
import os
import torch
from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.pipeline import run_pipeline

ref, fq, out = sys.argv[1:4]
config = PipelineConfig(name='D', out=out, ref=ref,
                        primers=('21q1', '17p6'), basecalled=fq,
                        exact_cigars=False, run_consensus=True)
run_pipeline(config, torch.device('cpu'))
base = os.path.join(out, 'D')
for suffix in ('.bwa_dodi.bam', '.bwa_dodi.bam.bai', '.mappings.bed',
               '.filter_counts_summary.csv', '.timings.json',
               '.without_primers.fq', '.mappings.cluster.bed',
               '.mappings.representative.bed', '.mappings_merged.bed',
               '.bwa_dodi_merged.bam'):
    assert os.path.exists(base + suffix), suffix
lines = open(base + '.filter_counts_summary.csv').read().splitlines()
counts = dict(zip(lines[1].split(','), lines[2].split(',')))
assert counts['total_kept'] == '5' and counts['junk_seqs_dropped'] == '1'
cons = open(os.path.join(out, 'cluster', 'D.cluster.consensus.fa')).read()
print('SLICE_OK', len(open(base + '.mappings.bed').readlines()),
      cons.count('>'))
'''


def _tiny(tmp_path):
    """The tiny two-group dataset, written before the port runs with the
    JAX package blocked."""
    from __graft_entry__ import write_tiny_dataset
    return write_tiny_dataset(str(tmp_path))


def test_slice_runs_with_jax_pandas_click_blocked(tmp_path):
    """Filter -> align -> clustering -> consensus on the CPU with jax,
    pandas, click and the JAX package blocked."""
    ref, fq = _tiny(tmp_path)
    res = subprocess.run([sys.executable, '-c', _SLICE, ref, fq,
                          str(tmp_path / 'out')],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert 'SLICE_OK' in res.stdout
    n_lines, n_cons = map(int, res.stdout.split('SLICE_OK')[1].split())
    assert n_lines > 1                                  # header + rows
    assert n_cons == 2                    # one consensus per planted group


_CLI = _BLOCK + r'''
import os
from fslr_tpu_torch import cli
from fslr_tpu_torch.io.bam import read_bam

ref, fq, out = sys.argv[1:4]
cli.main(['--name', 'D', '--out', out, '--ref', ref, '--primers',
          '21q1,17p6', '--basecalled', fq, '--consensus', '--device', 'cpu'])
_, _, records = read_bam(os.path.join(out, 'D.bwa_dodi_merged.bam'))
assert records
print('CLI_OK', len(open(os.path.join(out, 'D.mappings.cluster.bed'))
                    .readlines()))
'''


def test_cli_runs_with_jax_pandas_click_blocked(tmp_path):
    """The CLI's default run (clustering, exact CIGARs) plus --consensus
    needs none of the blocked modules."""
    ref, fq = _tiny(tmp_path)
    res = subprocess.run([sys.executable, '-c', _CLI, ref, fq,
                          str(tmp_path / 'out')],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split('CLI_OK')[1]) > 1      # header + rows


# defaults the port sets for its card, not the TPU's: the encounter count
# above which clustering's pairs spill to host memory (80 GB of HBM)
CARD_DEFAULTS = {'ClusterConfig': {'enum_spill_min_encounters': 1 << 31}}


def _card_defaults(cfg) -> dict:
    """A fslr_tpu config as a dict (nested configs too), with the
    settings of CARD_DEFAULTS in place of its own."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = _card_defaults(v) if dataclasses.is_dataclass(v) else v
    return {**out, **CARD_DEFAULTS.get(type(cfg).__name__, {})}


def test_config_defaults_equal_fslr_tpu():
    """Every config dataclass of the port has fslr_tpu's fields and
    defaults, but for the settings of CARD_DEFAULTS."""
    import fslr_tpu.config as jconfig

    import fslr_tpu_torch.config as tconfig
    names = sorted(n for n, v in vars(jconfig).items()
                   if dataclasses.is_dataclass(v) and isinstance(v, type))
    assert names == sorted(n for n, v in vars(tconfig).items()
                           if dataclasses.is_dataclass(v)
                           and isinstance(v, type))
    for n in names:
        assert dataclasses.asdict(getattr(tconfig, n)()) == \
            _card_defaults(getattr(jconfig, n)()), n
    port = port_config(jconfig.PipelineConfig())
    assert dataclasses.replace(port, cluster=dataclasses.replace(
        port.cluster, **CARD_DEFAULTS['ClusterConfig'])) == \
        tconfig.PipelineConfig()


def test_primers_csv_byte_equal():
    with open(os.path.join(REPO, 'fslr_tpu', 'data', 'primers.csv'),
              'rb') as a, \
            open(os.path.join(REPO, 'fslr_tpu_torch', 'data',
                              'primers.csv'), 'rb') as b:
        assert a.read() == b.read()


def test_version_equals_fslr_tpu():
    import fslr_tpu

    import fslr_tpu_torch
    assert fslr_tpu_torch.__version__ == fslr_tpu.__version__


@pytest.mark.parametrize('args', [(30, 4), (12, 3, 1_500_000)],
                         ids=['default_ref', 'small_ref'])
def test_dataset_generator_bytes_equal_bench(tmp_path, args):
    import bench

    from fslr_tpu_torch.tools.synth import make_dataset
    os.makedirs(tmp_path / 'port')
    os.makedirs(tmp_path / 'bench')
    t_ref, t_fq = make_dataset(str(tmp_path / 'port'), *args)
    j_ref, j_fq = bench.make_dataset(str(tmp_path / 'bench'), *args)
    for a, b in ((t_ref, j_ref), (os.path.join(t_fq, 'b0.fastq'),
                                  os.path.join(j_fq, 'b0.fastq'))):
        with open(a, 'rb') as fa, open(b, 'rb') as fb:
            assert fa.read() == fb.read(), a


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
