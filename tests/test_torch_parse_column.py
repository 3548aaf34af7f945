"""read_mappings' column typing (fslr_tpu_torch/stages/cluster.py:
_parse_column) against pandas, which fslr_tpu reads mappings.bed with.

* The witness: the golden scenario's six fusion reads (tests/
  test_golden_snapshot.py:_build without the single-segment read m0,
  whose inferred-primer row would put a primer name in the chrom column)
  against contigs named '11_1' and '1_11': the port's pipeline with
  clustering, and fslr_tpu's clustering of its mappings.bed; cluster and
  representative beds byte-equal.  Python's int() reads both names as
  111 (PEP 515 underscores), pandas keeps strings.
* Read names '1_2' and '12' stay two reads in the cluster bed.
* Every cell of a table of number, NA and boolean forms, typed as
  pd.read_csv types it, for the engine of each call site: pyarrow for
  clustering (fslr_tpu/pipeline.py), the C engine for the merges of a
  multi-process run and of the consensus stage; by _parse_column alone
  and by read_mappings on a written file (the host runtime's reader).
* read_mappings' two routes give identical dicts (keys in order, dtypes,
  values, the type of each object): the host runtime's reader
  (csrc/tsv.cpp) and the csv module with _parse_column, on the golden
  scenario's mappings.bed, the benchmark's generated mappings, quoted
  cells, CRLF and CR line ends, a header alone and number forms; a file
  that is no rectangle of cells goes whole to the csv module, and a byte
  that is not UTF-8 raises on both routes.
* All-digit contig names ('17', '21'): both packages raise TypeError in
  rename_chromosomes, a fault of the reference kept for parity.
"""

import io
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from fslr_tpu.config import PipelineConfig as JaxPipelineConfig
from fslr_tpu.pipeline import run_pipeline as jax_run_pipeline
from fslr_tpu.stages import cluster as jcluster
from benchmark import gen
from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.instrument import StageTimer, activate
from fslr_tpu_torch.io import bam as bamio
from fslr_tpu_torch.pipeline import run_pipeline
from fslr_tpu_torch.stages import cluster as tcluster
from fslr_tpu_torch.stages import mapping_table
from tests.test_golden_snapshot import _build

CPU = torch.device('cpu')
CONTIGS = {'chrA': '11_1', 'chrB': '1_11'}
BEDS = ('.mappings.cluster.bed', '.mappings.representative.bed')


def _read(path):
    with open(path, 'rb') as fh:
        return fh.read()


def _witness_data(root):
    """The golden scenario without m0, its contigs renamed."""
    ref, fq_dir = _build(root)
    with open(ref) as fh:
        text = fh.read()
    for old, new in CONTIGS.items():
        text = text.replace(f'>{old}\n', f'>{new}\n')
    with open(ref, 'w') as fh:
        fh.write(text)
    fq = os.path.join(fq_dir, 'b.fastq')
    with open(fq) as fh:
        lines = fh.read().splitlines(keepends=True)
    records = [lines[i:i + 4] for i in range(0, len(lines), 4)]
    with open(fq, 'w') as fh:
        fh.writelines(line for rec in records
                      if rec[0] != '@m0\n' for line in rec)
    return ref, fq_dir


@pytest.fixture(scope='module')
def witness(tmp_path_factory):
    """The port's pipeline (approximate CIGARs, clustering on) on the
    witness data, its read_mappings calls recorded; then fslr_tpu's
    pipeline clustering the port's mappings.bed and BAM (skip_alignment:
    the alignment stages' equality is held elsewhere,
    tests/test_torch_pipeline_cluster.py, and contig names do not move
    it)."""
    root = str(tmp_path_factory.mktemp('witness'))
    ref, fq = _witness_data(root)
    engines = []
    read = tcluster.read_mappings

    def recorded(path, **kw):
        engines.append(kw.get('engine'))
        return read(path, **kw)

    kw = dict(name='W', ref=ref, primers=('21q1', '17p6'), basecalled=fq,
              exact_cigars=False)
    out = os.path.join(root, 'torch')
    tcluster.read_mappings = recorded
    try:
        run_pipeline(PipelineConfig(out=out, **kw), CPU)
    finally:
        tcluster.read_mappings = read
    jout = os.path.join(root, 'jax')
    os.makedirs(jout)
    for suffix in ('.mappings.bed', '.bwa_dodi.bam'):
        shutil.copy(os.path.join(out, 'W' + suffix),
                    os.path.join(jout, 'W' + suffix))
    jax_run_pipeline(JaxPipelineConfig(out=jout, skip_alignment=True, **kw),
                     backend='jax')
    return dict(bases={'torch': os.path.join(out, 'W'),
                       'jax': os.path.join(jout, 'W')},
                engines=engines)


@pytest.mark.parametrize('suffix', BEDS)
def test_underscored_contigs_give_equal_beds(witness, suffix):
    got = _read(witness['bases']['torch'] + suffix)
    assert got == _read(witness['bases']['jax'] + suffix)
    assert got.count(b'\n') > 1
    if suffix == '.mappings.cluster.bed':
        assert b'\t11_1\t' in got or got.startswith(b'11_1\t') \
            or b'\n11_1\t' in got


def test_clustering_reads_as_pyarrow(witness):
    assert witness['engines'] == ['pyarrow']


def _relabelled(path, out, names=None, chroms=None):
    """The bed at ``path`` with each read's name replaced through
    ``names`` (by its prefix before the first '.') and contigs through
    ``chroms``."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    header = lines[0].split('\t')
    qi, ci = header.index('qname'), header.index('chrom')
    rows = []
    for line in lines[1:]:
        f = line.split('\t')
        if names:
            f[qi] = names[f[qi].split('.')[0]]
        if chroms:
            f[ci] = chroms.get(f[ci], f[ci])
        rows.append('\t'.join(f))
    with open(out, 'w') as fh:
        fh.write('\n'.join([lines[0]] + rows) + '\n')
    return out


def _cluster_both(bed, chr_lengths, tmp_path):
    """Each package's clustering of ``bed`` (read as its pipeline reads
    it); the written cluster and representative beds per package."""
    jres = jcluster.cluster_stage(pd.read_csv(bed, sep='\t',
                                              engine='pyarrow'),
                                  chr_lengths, JaxPipelineConfig().cluster)
    tres = tcluster.cluster_stage(tcluster.read_mappings(bed), chr_lengths,
                                  PipelineConfig().cluster, CPU)
    out = {}
    for tag, res in (('jax', jres), ('torch', tres)):
        for suffix, table in (('.cluster.bed', res.cluster_bed),
                              ('.representative.bed',
                               res.representative_bed)):
            p = str(tmp_path / f'{tag}{suffix}')
            if tag == 'jax':
                table.to_csv(p, index=False, sep='\t')
            else:
                mapping_table.write_mappings_bed(table, p)
            out[(tag, suffix)] = _read(p)
    return out


def test_digit_underscore_read_names_stay_apart(witness, tmp_path):
    """Reads named '1_2' and '12' (int() reads both as 12) are two reads
    of one cluster in both packages' cluster beds."""
    base = witness['bases']['torch']
    names = {'r0': '1_2', 'r2': '12', 'r4': '3_4', 'r1': '5_6', 'r3': '56',
             'r5': '7'}
    bed = _relabelled(base + '.mappings.bed', str(tmp_path / 'q.bed'),
                      names=names)
    out = _cluster_both(bed, bamio.get_chromosome_lengths(
        base + '.bwa_dodi.bam'), tmp_path)
    for suffix in ('.cluster.bed', '.representative.bed'):
        assert out[('torch', suffix)] == out[('jax', suffix)], suffix
    got = pd.read_csv(io.BytesIO(out[('torch', '.cluster.bed')]), sep='\t',
                      dtype=str)
    assert {'1_2', '12'} <= set(got['qname'])
    assert got.loc[got['qname'] == '1_2', 'cluster'].iloc[0] == \
        got.loc[got['qname'] == '12', 'cluster'].iloc[0]


def test_all_digit_contigs_raise_in_both_packages(witness, tmp_path):
    """The reference's all-digit contig fault, kept: pandas types the chrom
    column int64 and rename_chromosomes slices a name."""
    base = witness['bases']['torch']
    bed = _relabelled(base + '.mappings.bed', str(tmp_path / 'd.bed'),
                      chroms={'11_1': '17', '1_11': '21'})
    lengths = {'17': 400_000, '21': 400_000}
    with pytest.raises(TypeError):
        jcluster.cluster_stage(pd.read_csv(bed, sep='\t', engine='pyarrow'),
                               lengths, JaxPipelineConfig().cluster)
    with pytest.raises(TypeError):
        tcluster.cluster_stage(tcluster.read_mappings(bed), lengths,
                               PipelineConfig().cluster, CPU)


# number, NA and boolean cells on which Python's int()/float() and pandas
# differ, and the forms around them
CELLS = ['11_1', '1_000.5', '١٢', 'NA', 'null', 'None', 'N/A',
         'nan', 'NaN', '', 'True', 'False', 'true', 'tRue', '0x10', '0X1f',
         '-0x10', '+5', '-5', ' 12', '12 ', '007', '1e3', '1.e3', '.5',
         '+.5', 'inf', '-Infinity', 'NAN', 'nan(1)', '1e', '0', '1',
         '１２', '1 2', ' NA', ' True', 'x', 'chr1', '21q1', '1e400',
         '1e-400', '4.9e-324']
# a column is the cell alone, or beside one of these
OTHERS = ('7', 'NA', 'x', 'True', '1.5')


def _same(got: np.ndarray, want: pd.Series) -> bool:
    kind = 'O' if want.dtype == object or str(want.dtype) == 'str' \
        else want.dtype.kind
    if got.dtype.kind != kind or len(got) != len(want):
        return False
    for a, b in zip(got.tolist(), want.tolist()):
        if isinstance(a, float) and isinstance(b, float) and np.isnan(a):
            if not np.isnan(b):
                return False
        elif type(a) is not type(b) or a != b:
            return False
    return True


@pytest.mark.parametrize('engine', ['c', 'pyarrow'])
@pytest.mark.parametrize('cell', CELLS)
def test_parse_column_types_as_pandas(cell, engine):
    for column in ([cell],) + tuple([cell, o] for o in OTHERS):
        text = 'h\tz\n' + ''.join(f'{c}\t0\n' for c in column)
        want = pd.read_csv(io.StringIO(text), sep='\t', engine=engine)['h']
        got = tcluster._parse_column(list(column), engine)
        assert _same(got, want), (column, got, want.tolist(), want.dtype)


@pytest.mark.parametrize('engine', ['c', 'pyarrow'])
@pytest.mark.parametrize('cell', CELLS)
def test_read_mappings_types_as_pandas(cell, engine, tmp_path):
    """The same table through read_mappings on a written file."""
    for k, column in enumerate(([cell],) + tuple([cell, o] for o in OTHERS)):
        text = 'h\tz\n' + ''.join(f'{c}\t0\n' for c in column)
        path = tmp_path / f'{k}.tsv'
        path.write_bytes(text.encode())
        want = pd.read_csv(io.StringIO(text), sep='\t', engine=engine)['h']
        got = tcluster.read_mappings(str(path), engine)['h']
        assert _same(got, want), (column, got, want.tolist(), want.dtype)


@pytest.mark.parametrize('engine', ['c', 'pyarrow'])
def test_parse_column_keeps_int64_bounds(engine):
    column = ['9223372036854775807', '-9223372036854775808']
    got = tcluster._parse_column(column, engine)
    assert got.dtype == np.int64 and got.tolist() == [2 ** 63 - 1, -2 ** 63]


def test_read_mappings_refuses_an_unknown_engine(tmp_path):
    path = tmp_path / 'x.bed'
    path.write_text('a\n1\n')
    with pytest.raises(ValueError, match='engine'):
        tcluster.read_mappings(str(path), engine='python')


# ---------------------------------------------------------------------------
# read_mappings' two routes: the host runtime's reader against the csv
# module with _parse_column
# ---------------------------------------------------------------------------

GOLDEN_BED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'golden', 'mappings.golden.bed')
QUOTED = ('chrom\t"q""name"\tn\tnote\n'
          '"chr1"\t"a\tb"\t"12"\t"two\nlines"\n'
          'chr1\t"say ""hi"""\t7\t"crlf\r\nand\rcr"\n'
          '"chr2"\t""\t"NA"\t"x"\n')
# number forms, each column beside a plain one; the values where
# float() and int() round or overflow, the forms the runtime leaves to
# _parse_column (hexadecimal, nan forms, beyond int64, re.I's letters)
NUMBERS = {
    'int_na': ['9007199254740993', 'NA', '-9223372036854775808',
               '9223372036854775807', '  -7 ', '007'],
    'float': ['2.4703282292062328e-324', '1e-400', '-1e-400', '4.9e-324',
              '1.7976931348623157e308', '1e400', '-Infinity', ' .5',
              '1.e3', '+inf', '-0', '0.1'],
    'float_na': ['', '1.5', 'n/a', '-0.0', '123456789012345678901234567'],
    'bool_na': ['True', 'NA', 'false', 'TRUE', 'null', 'False'],
    'bool': ['1', 'True', '0', 'false', 'FALSE', 'TRUE'],
    'plus': ['+5', '-5', '+0', '12', '13', '14'],
    'hex': ['0x10', '0X1f', '7', '8', '9', '10'],
    'nan': ['NAN', 'nan(1)', '1.5', 'nAn', '+nan', '2'],
    'wide': ['99999999999999999999', '1', '2', '3', '4', '5'],
    'letters': ['nan(\u017f)', 'NA', '3', 'nan(\u212a)', '4', '5'],
    'text': ['chr1', '11_1', '\u0661\u0662', 'NA', ' NA', 'chr1'],
}


def _number_text() -> str:
    n = max(len(v) for v in NUMBERS.values())
    cols = {k: v + [v[-1]] * (n - len(v)) for k, v in NUMBERS.items()}
    return '\t'.join(cols) + '\n' + ''.join(
        '\t'.join(c[i] for c in cols.values()) + '\n' for i in range(n))


def _csv_route(path: str, engine: str) -> dict:
    header, cols = tcluster._csv_columns(path)
    return {h: tcluster._parse_column(list(c), engine)
            for h, c in zip(header, cols)}


def _read_counted(path: str, engine: str):
    timer = StageTimer()
    with activate(timer):
        got = tcluster.read_mappings(path, engine)
    return got, timer.notes['read_mappings']


def _assert_identical(got: dict, want: dict):
    assert list(got) == list(want)
    for key in want:
        a, b = got[key], want[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        for x, y in zip(a.tolist(), b.tolist()):
            assert type(x) is type(y), (key, x, y)
            if isinstance(x, float):
                assert np.isnan(x) == np.isnan(y), (key, x, y)
                if not np.isnan(x):
                    assert x == y and np.signbit(x) == np.signbit(y), (key,
                                                                      x, y)
            else:
                assert x == y, (key, x, y)


@pytest.fixture(scope='module')
def route_files(tmp_path_factory):
    """Files both routes read, by name: the golden scenario's
    mappings.bed as write_mappings_bed writes it, a benchmark sample's
    mappings as gen.bed_text writes them, and hand-made forms."""
    root = tmp_path_factory.mktemp('routes')
    files = {}
    golden = str(root / 'golden.bed')
    mapping_table.write_mappings_bed(_csv_route(GOLDEN_BED, 'pyarrow'),
                                     golden)
    files['golden'] = golden
    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'benchmark')
    with open(os.path.join(bench, 'configs', 'tf2p_recluster.json')) as fh:
        cfg = json.load(fh)
    cfg['contigs'] = [[n, 1_100_000 + 10_000 * i]
                      for i, (n, _) in enumerate(cfg['contigs'])]
    with open(os.path.join(bench, 'mixes', 'dup700_near.json')) as fh:
        mix = json.load(fh)
    mix.update(reads_per_sample=400, samples=1, group_size=20)
    ref = str(root / 'ref.fa')
    gen.write_reference(cfg, ref)
    sample = gen.make_sample(cfg, mix, gen.Reference(cfg, ref), 2**40 + 9,
                             400)
    for name, data in (
            ('gen', gen.bed_text(gen.mappings(cfg, sample, 2**33 + 1))),
            ('quoted', QUOTED.encode()),
            ('crlf_no_last_line_end',
             b'a\tb\tc\r\n1\tx\t2.5\r\n2\t\t\r\n3\ty\tNA'),
            ('cr', b'a\tb\r1\tx\r2\ty\r'),
            ('header_only', b'chrom\trstart\tqname\n'),
            ('header_only_no_line_end', b'chrom\trstart'),
            ('empty_last_field', b'a\tb\n1\t\n2\t'),
            ('numbers', _number_text().encode())):
        files[name] = str(root / f'{name}.tsv')
        with open(files[name], 'wb') as fh:
            fh.write(data)
    return files


@pytest.mark.parametrize('engine', ['c', 'pyarrow'])
@pytest.mark.parametrize('name', ['golden', 'gen', 'quoted',
                                  'crlf_no_last_line_end', 'cr',
                                  'header_only', 'header_only_no_line_end',
                                  'empty_last_field', 'numbers'])
def test_read_mappings_routes_identical(route_files, name, engine):
    path = route_files[name]
    got, note = _read_counted(path, engine)
    _assert_identical(got, _csv_route(path, engine))
    assert note['python_file'] == 0
    assert note['native_columns'] + note['python_columns'] == len(got)
    if name in ('golden', 'gen'):
        assert note == {'native_columns': len(got), 'python_columns': 0,
                        'python_file': 0}
        assert got['qname'].dtype == object and len(got['qname']) > 10
    if name == 'numbers':
        # the columns left to _parse_column: beyond int64, and pyarrow's
        # hexadecimal, nan forms and re.I's letters (strings to C)
        left = ('wide', 'hex', 'nan', 'letters') if engine == 'pyarrow' \
            else ('wide',)
        assert note['python_columns'] == len(left)


@pytest.mark.parametrize('engine', ['c', 'pyarrow'])
def test_read_mappings_na_tokens_are_parse_columns(tmp_path, engine):
    """The runtime's NA tokens are NA_TOKENS: each token, and a near miss
    of each, beside an integer and beside a string."""
    near = sorted({t.lower() for t in tcluster.NA_TOKENS}
                  | {t.upper() for t in tcluster.NA_TOKENS}
                  | {t + ' ' for t in tcluster.NA_TOKENS}
                  | {'#N/A  N/A', '1.#INF', '<na>', 'Na', 'NaN0'})
    for k, token in enumerate(sorted(tcluster.NA_TOKENS) + near):
        for other in ('1', 'x'):
            path = str(tmp_path / f'{k}_{other}.tsv')
            with open(path, 'wb') as fh:
                fh.write(f'h\tz\n{token}\t0\n{other}\t0\n'.encode())
            got, note = _read_counted(path, engine)
            _assert_identical(got, _csv_route(path, engine))
            assert note['python_file'] == 0, token


@pytest.mark.parametrize('engine', ['c', 'pyarrow'])
@pytest.mark.parametrize('text', [
    'a\tb\n1\t2\n3\n',                 # a short row
    'a\tb\n1\t2\t3\n4\t5\n',         # a long row
    'a\tb\n1\t2\n\n3\t4\n',          # a blank line
    'a\tb\n1\t2\n\n',                 # a blank last line
    'a\tb\n1\tx"y\n',                  # a quote in an unquoted field
    'a\tb\n1\t"x"y\n',                 # text after a closing quote
    'a\tb\n1\t"xy\n',                  # an unterminated quote
    'a\tb\n1\t2\x00\n',               # a NUL
    '\n'],                               # no header
    ids=['short_row', 'long_row', 'blank_line', 'blank_last_line',
         'quote_in_field', 'after_quote', 'unterminated', 'nul',
         'no_header'])
def test_read_mappings_reads_odd_files_whole_with_csv(tmp_path, text,
                                                      engine):
    """A file that is no rectangle of cells goes whole to the csv route,
    which keeps its oddities (a blank line or a short row truncates every
    column)."""
    path = str(tmp_path / 'odd.tsv')
    with open(path, 'wb') as fh:
        fh.write(text.encode())
    got, note = _read_counted(path, engine)
    _assert_identical(got, _csv_route(path, engine))
    assert note == {'native_columns': 0, 'python_columns': 0,
                    'python_file': 1}


def test_read_mappings_empty_file_raises_as_csv(tmp_path):
    path = str(tmp_path / 'empty.tsv')
    open(path, 'wb').close()
    with pytest.raises(IndexError):
        _csv_route(path, 'pyarrow')
    with pytest.raises(IndexError):
        tcluster.read_mappings(path)


@pytest.mark.parametrize('engine', ['c', 'pyarrow'])
@pytest.mark.parametrize('data', [b'a\tb\n1\tx\xff\n',
                                  b'a\tb\n1\t"\xc3"\n',
                                  b'a\xe2\x82\tb\n1\t2\n'],
                         ids=['string_cell', 'quoted_cut', 'header'])
def test_read_mappings_non_utf8_raises_as_csv(tmp_path, data, engine):
    path = str(tmp_path / 'bad.tsv')
    with open(path, 'wb') as fh:
        fh.write(data)
    with pytest.raises(UnicodeDecodeError):
        _csv_route(path, engine)
    with pytest.raises(UnicodeDecodeError):
        tcluster.read_mappings(path, engine)


@pytest.mark.parametrize('engine', ['c', 'pyarrow'])
def test_read_mappings_faults_of_parse_column_kept(tmp_path, engine):
    """'ınf' (a dotless i): _parse_column's regex takes it for a float and
    float() refuses it; read_mappings leaves the column to _parse_column,
    so both routes raise the same error."""
    path = str(tmp_path / 'inf.tsv')
    with open(path, 'wb') as fh:
        fh.write('a\tb\n\u0131nf\t1\n'.encode())
    with pytest.raises(ValueError):
        _csv_route(path, engine)
    with pytest.raises(ValueError):
        tcluster.read_mappings(path, engine)
