"""What the comparison that decides ``correct`` reads on the program, on
the control and on each fault the cell can have, at a size a test run
holds: the harness's set-up, window and comparison, driven on the CPU
(or the card, with the ``cuda`` marker) past the harness's look for a
card.

* control ``approx_cigars`` (tf2p's): the program's approximate CIGARs;
* half of the batch left out: the pipeline reads every other input file;
* an answer altered where it is produced: every alignment's score + 1.

A step that returns its state unchanged and the exchange between chips
do not exist in this one-card cell.  The program as the configuration
states it reads 0 on every number but those that its known faults move
(``bad_records``, ``bed_rows``, ``missed_segments``: PERF.md, Open
questions); each control and fault reads more than it on the number
that catches it, and not correct."""

import json
import os

import pytest
import torch

from benchmark import control, run

CLEAN = ('filter_reads', 'filter_counts', 'wrong_labels',
         'misplaced_records', 'suboptimal', 'mixed_clusters')
CAUGHT = {'approx_cigars': 'bad_records', 'half_batch': 'filter_counts',
          'score_plus_one': 'bad_records'}


def _cell():
    with open(os.path.join(run.HERE, 'configs', 'tf2p.json')) as fh:
        cfg = json.load(fh)
    cfg['name'] = 'test_' + cfg['name']
    cfg['contigs'] = [[n, 1_100_000 + 20_000 * i]
                      for i, (n, _) in enumerate(cfg['contigs'])]
    with open(os.path.join(run.HERE, 'mixes', 'dup700.json')) as fh:
        mix = json.load(fh)
    mix.update(reads_per_sample=24, samples=1, reads_per_file=6,
               group_size=12, judge_reads=12, judge_dp=4,
               bread_bp=[300, 900], filling_bp=[300, 600])
    return cfg, mix


@pytest.fixture(autouse=True)
def _cache(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(run, 'CACHE', str(tmp_path_factory.getbasetemp()
                                          / 'bench_cache'))


def _run(device, alter=None):
    cfg, mix = _cell()
    result, _lines, _where = run.run_cell(
        cfg, mix, ['reads_per_s', 'setup_s'], [], 2**35 + 11, 0.01, False,
        device, alter=alter)
    return result, {k: v['value'] for k, v in result['compared'].items()}


_SOUND: dict = {}


def _sound(device):
    if device.type not in _SOUND:
        _SOUND[device.type] = _run(device)
    return _SOUND[device.type]


def _check(case, device, monkeypatch):
    result, compared = _sound(device)
    if case == 'sound':
        assert result['attempted'] == 1 and not result['failed']
        assert set(compared) == set(CLEAN) | {'bad_records', 'bed_rows',
                                              'missed_segments'}
        assert not any(compared[k] for k in CLEAN), compared
        return
    alter = control.CONTROLS.get(case)
    if case in control.FAULTS:
        control.FAULTS[case](monkeypatch.setattr)
    faulty, got = _run(device, alter)
    assert not faulty['correct'], got
    k = CAUGHT[case]
    assert got[k] > compared[k], (got, compared)


CASES = ['sound', 'approx_cigars', 'half_batch', 'score_plus_one']


@pytest.mark.parametrize('case', CASES)
def test_correct_on_cpu(case, monkeypatch):
    _check(case, torch.device('cpu'), monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES)
def test_correct_on_the_card(case, card, monkeypatch):
    _check(case, card, monkeypatch)
