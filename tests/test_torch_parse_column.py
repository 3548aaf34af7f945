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
  multi-process run and of the consensus stage.
* All-digit contig names ('17', '21'): both packages raise TypeError in
  rename_chromosomes, a fault of the reference kept for parity.
"""

import io
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from fslr_tpu.config import PipelineConfig as JaxPipelineConfig
from fslr_tpu.pipeline import run_pipeline as jax_run_pipeline
from fslr_tpu.stages import cluster as jcluster
from fslr_tpu_torch.config import PipelineConfig
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
         '１２', '1 2', ' NA', ' True', 'x', 'chr1', '21q1', '1e400']
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
def test_parse_column_keeps_int64_bounds(engine):
    column = ['9223372036854775807', '-9223372036854775808']
    got = tcluster._parse_column(column, engine)
    assert got.dtype == np.int64 and got.tolist() == [2 ** 63 - 1, -2 ** 63]


def test_read_mappings_refuses_an_unknown_engine(tmp_path):
    path = tmp_path / 'x.bed'
    path.write_text('a\n1\n')
    with pytest.raises(ValueError, match='engine'):
        tcluster.read_mappings(str(path), engine='python')
