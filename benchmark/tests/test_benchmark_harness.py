"""The harness: BENCHMARK.json against the contract's form, every
configuration, mix, metric and kernel-work file found by its name, an
unknown name refused, and no result without a card."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import run

ROOT = run.ROOT
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def _bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fh:
        return json.load(fh)


def test_benchmark_json_form():
    b = _bench()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert b['paths'] == ['benchmark']
    assert 1 <= b['run_seconds'] <= 51
    names = [m['name'] for m in b['end_to_end'] + b['per_layer']]
    names += [w['name'] for w in b['workloads']]
    names += [c['name'] for c in b['configs']]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert 'setup_s' in [m['name'] for m in b['end_to_end']]
    for m in b['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    e2e = {m['name'] for m in b['end_to_end']}
    for m in b['end_to_end'] + b['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for m in b['per_layer']:
        assert m['moves'] in e2e
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
    cells = {w['name'] for w in b['workloads']}
    for w in b['workloads']:
        assert len(w['why']) <= 200 and w['chips'] in (1, 4)
    for m in b['per_layer'] + b['end_to_end']:
        assert set(m.get('workloads', cells)) <= cells
    for c in b['configs']:
        assert c['file'].startswith('benchmark/')
        with open(os.path.join(ROOT, c['file'])) as fh:
            cfg = json.load(fh)
        assert cfg['name'] == c['name']
        assert sorted(c['reduced']) == sorted(cfg['reduced'])


def test_every_cell_loads_by_name():
    b = _bench()
    for w in b['workloads']:
        cell, config, mix, e2e, layer = run.load_cell(w['name'])
        assert config['name'] == w['config'] and mix['name'] == w['traffic']
        assert 'reads_per_s' in e2e and 'setup_s' in e2e
        assert layer
        units = {m['name']: m['unit'] for m in b['per_layer']}
        for name in layer:
            mod = run.load_module('metrics', name)
            assert callable(mod.read) and mod.UNIT == units[name]
        assert config['control']
    assert callable(run.load_module('work', 'mask_kernel').work)


def test_unknown_names_refused():
    with pytest.raises(SystemExit):
        run.load_cell('no_such.cell')
    for kind in ('configs', 'mixes'):
        with pytest.raises(SystemExit):
            run.load_json(kind, 'no_such')
    with pytest.raises(SystemExit):
        run.load_module('metrics', 'no_such.metric')


def _no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present: the run would measure')


def _run(cwd):
    cell = _bench()['workloads'][0]['name']
    return subprocess.run(
        [sys.executable, '-m', 'benchmark.run', '--workload', cell,
         '--seed', str(2**40 + 1), '--seconds', '1', '--trace', '0'],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    _no_card()
    r = _run(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ''
    assert 'CUDA' in r.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    _no_card()
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(ROOT, 'benchmark'), tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('_cache', '__pycache__'))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ''
