"""The port's PAF filter (fslr_tpu_torch/tools/filter_paf.py) against
fslr_tpu's on the cases of tests/test_filter_paf.py: the same decisions,
and the same stdout and stderr from ``run`` and from the command line."""

import io
import subprocess
import sys

import pytest

from fslr_tpu.tools import filter_paf as jpaf
from fslr_tpu_torch.tools import filter_paf as tpaf
from tests.test_filter_paf import _paf

ROWS = [  # (row, min_coverage): the rules of test_row_rules
    (_paf('a', 100, 0, 100, 'a', 100, 0, 100, 100), 0.5),   # self-hit
    (_paf('a', 100, 0, 100, 'b', 100, 0, 100, 90), 0.8),    # kept
    (_paf('a', 100, 0, 70, 'b', 100, 0, 100, 70), 0.8),     # low qcov
    (_paf('a', 100, 0, 100, 'b', 200, 0, 150, 100), 0.8),   # low tcov
    (_paf('a', 100, 0, 100, 'b', 250, 0, 250, 90), 0.3),    # few matches
    (_paf('a', 100, 10, 90, 'b', 100, 10, 90, 60), 0.8),    # at the bound
]
STREAM = [_paf('a', 100, 0, 100, 'b', 100, 0, 100, 95),
          _paf('a', 100, 0, 100, 'a', 100, 0, 100, 95),
          _paf('c', 100, 0, 40, 'b', 100, 0, 100, 40),
          _paf('x', 50, 0, 50, 'y', 50, 0, 50, 48)]


@pytest.mark.parametrize('row,cov', ROWS)
def test_row_decisions_equal(row, cov):
    fields = row.split('\t')
    assert tpaf.row_passes(fields, cov) == jpaf.row_passes(fields, cov)


@pytest.mark.parametrize('cov', [0.0, 0.8, 0.9, 1.0])
@pytest.mark.parametrize('n_lines', [0, 1, 4])
def test_run_output_equal(cov, n_lines):
    text = ''.join(line + '\n' for line in STREAM[:n_lines])
    outs = []
    for mod in (jpaf, tpaf):
        out, err = io.StringIO(), io.StringIO()
        mod.run(io.StringIO(text), out, err, cov)
        outs.append((out.getvalue(), err.getvalue()))
    assert outs[0] == outs[1]
    assert 'Input alignments: ' in outs[1][1]


def test_cli_output_equal():
    text = ''.join(line + '\n' for line in STREAM)
    res = [subprocess.run([sys.executable, '-m', f'{pkg}.tools.filter_paf',
                           '0.9'], input=text, capture_output=True,
                          text=True)
           for pkg in ('fslr_tpu', 'fslr_tpu_torch')]
    assert [r.returncode for r in res] == [0, 0]
    assert res[1].stdout == res[0].stdout == \
        STREAM[0] + '\n' + STREAM[3] + '\n'
    assert res[1].stderr == res[0].stderr
