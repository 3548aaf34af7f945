"""Nothing under benchmark/ imports JAX or the JAX package (top-level
names compared whole: ``fslr_tpu_torch`` is not ``fslr_tpu``); the
comparison that decides ``correct`` imports nothing of the program
either; nothing reads the repository's bench scripts or their
results."""

import ast
import os
import subprocess
import sys

from benchmark import run

BENCH = os.path.join(run.ROOT, 'benchmark')
JAX = {'jax', 'jaxlib', 'flax', 'fslr_tpu'}
REFERENCE = ('judge.py', 'judge_clusters.py', 'gen.py')
NOT_READ = ('bench.py', 'chip_smoke.py', 'chip_ab.py', 'BENCH_')


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _strings(path):
    """String constants that are not docstrings."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    docs = {id(n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.value


def test_no_jax_anywhere():
    for path in _sources():
        tops = {m.split('.')[0] for m in _imports(path)}
        assert not tops & JAX, (path, tops & JAX)


def test_reference_imports_nothing_of_the_program():
    for path in _sources():
        rel = os.path.relpath(path, BENCH)
        if rel.startswith(REFERENCE):
            tops = {m.split('.')[0] for m in _imports(path)}
            assert 'fslr_tpu_torch' not in tops, rel


def test_no_bench_scripts_read():
    for path in _sources():
        if os.sep + 'tests' + os.sep in path:
            continue
        mods = set(_imports(path))
        assert not mods & {'bench', 'chip_smoke', 'chip_ab',
                           'fslr_tpu_torch.bench'}, path
        for s in _strings(path):
            assert not any(x in s for x in NOT_READ), (path, s)


def test_loaded_modules_in_a_run_process():
    code = ('import sys; import benchmark.run as r, '
            'benchmark.judge, benchmark.judge_clusters, benchmark.control; '
            'import fslr_tpu_torch.pipeline, fslr_tpu_torch.cli; '
            'print(r.forbidden_modules())')
    out = subprocess.run([sys.executable, '-c', code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
