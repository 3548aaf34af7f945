"""The port's FASTX parser (fslr_tpu_torch/csrc/fastx.cpp, io/native.py)
against fslr_tpu's stage reader and the port's plain Python parser, field
by field; gzip files that zlib's gzread (fslr_tpu's reader) reads and
Python's gzip module refuses; where its library is built and loaded from,
one library of both host sources (fastx.cpp and the table reader
tsv.cpp); and that a failed build or load raises instead of falling
back."""

import gzip
import hashlib
import os
import sys
import threading
import zlib

import numpy as np
import pytest

from fslr_tpu.io import fastq as jfastq
from fslr_tpu.io import native as jnative

from fslr_tpu_torch.io import fastq, native
from fslr_tpu_torch.tools.synth import gzip_forms, gzip_members, make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ('codes', 'lower', 'seq_off', '_names', 'name_off', '_quals',
          'qual_off', '_comments', 'comment_off')

FASTQ = (b'@r1 run=7 ch=12\nACGTNacgtn\n+\nIIIIIIIIII\n'
         b'@r2\nACGTACGTAAAAaaaaCCCC\n+\n!!!!!!!!!!!!!!!!!!!!\n'
         b'@r3\tflow=3\nTTTT\n+\n####\n')
FASTA = (b'>chr1 first contig\nACGTACGTAC\nacgtacgtac\nNNNNACGT\n'
         b'>chr2\nGGGGCCCC\n>chr3 x\nA\n')
# symbols outside ACGTN, lowercase ones among them, and lowercase runs
SYMBOLS = (b'@s1 c\nACGRYKMSWBDHVNacgrykmswbdhvn-.*xX\n+\n'
           + b'I' * 34 + b'\n@s2\naaaaaaaaaACGTTTTTTttttttGG\n+\n'
           + b'5' * 26 + b'\n')
NO_NEWLINE = b'@a one\nACGT\n+\nIIII\n@b\nGGcc\n+\nIIII'
NO_NEWLINE_FA = b'>a\nACGT\nAC\n>b two\nggCC'


CASES = {
    'fastq': ('r.fastq', FASTQ),
    'fasta': ('r.fa', FASTA),
    'gzip': ('r.fastq.gz', gzip.compress(FASTQ)),
    'gzip_two_members': ('r.fastq.gz', gzip_members(FASTQ, 2)),
    'gzip_fasta_two_members': ('r.fa.gz', gzip_members(FASTA, 2)),
    'symbols_and_lowercase': ('s.fq', SYMBOLS),
    'empty': ('e.fastq', b''),
    'no_trailing_newline': ('n.fastq', NO_NEWLINE),
    'no_trailing_newline_fasta': ('n.fa', NO_NEWLINE_FA),
}


@pytest.fixture(scope='module')
def built():
    """One build of the parser for the module's tests."""
    return native.library()


def _write(tmp_path, name, data) -> str:
    path = str(tmp_path / name)
    with open(path, 'wb') as fh:
        fh.write(data)
    return path


def _assert_same(got, want):
    assert got.n == want.n
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize('case', list(CASES))
def test_read_reads_equals_fslr_tpu_and_the_plain_parser(tmp_path, built,
                                                         case):
    path = _write(tmp_path, *CASES[case])
    got = fastq.read_reads(path)
    _assert_same(got, fastq.records_to_arrays(fastq._read_fastx_py(path)))
    _assert_same(got, jfastq.read_reads(path))


def test_read_reads_strings_round_trip(tmp_path, built):
    """Names, comments, qualities and lowercase survive as strings."""
    fa = fastq.read_reads(_write(tmp_path, 'r.fastq', FASTQ))
    assert fa.name_strs() == ['r1', 'r2', 'r3']
    assert [fa.comment(i) for i in range(3)] == ['run=7 ch=12', None,
                                                 'flow=3']
    assert fa.seq_strs()[:2] == ['ACGTNacgtn', 'ACGTACGTAAAAaaaaCCCC']
    assert fa.qual_strs()[2] == '####'


def test_slice_fastq_equals_the_plain_parser(tmp_path, built):
    """A dataset the pipeline runs on, plain and as a gzip of two
    members."""
    from fslr_tpu_torch.tools.synth import make_dataset
    _, fq = make_dataset(str(tmp_path), 200, 10)
    path = os.path.join(fq, 'b0.fastq')
    with open(path, 'rb') as fh:
        gz = _write(tmp_path, 'b0.fastq.gz', gzip_members(fh.read(), 2))
    for p in (path, gz):
        got = fastq.read_reads(p)
        assert got.n == 200
        _assert_same(got, fastq.records_to_arrays(fastq._read_fastx_py(p)))


@pytest.fixture(scope='module')
def slice_fastq(tmp_path_factory):
    """A dataset's FASTQ (200 reads) and a directory for its gzip forms."""
    root = tmp_path_factory.mktemp('gzip_forms')
    _, fq = make_dataset(str(root), 200, 10)
    with open(os.path.join(fq, 'b0.fastq'), 'rb') as fh:
        return root, fh.read()


@pytest.mark.parametrize('form', ['text_after_last_member',
                                  'two_members_then_xyz', 'first_half',
                                  'trailer_cut_by_6', 'trailing_zeros',
                                  'bad_crc'])
def test_gzip_forms_read_as_fslr_tpu_reads_them(slice_fastq, built, form):
    """fslr_tpu reads these through zlib's gzread (its prebuilt native
    library, not its Python fallback): trailing text or zeros end the
    input, a cut member yields what it inflated, a bad CRC raises.  The
    port's read_reads equals it field by field, or raises with it."""
    root, data = slice_fastq
    path = str(root / f'{form}.fq.gz')
    with open(path, 'wb') as fh:
        fh.write(gzip_forms(data)[form])
    if form == 'bad_crc':
        # the native read fails (gzread's -1); not None: the library ran
        with pytest.raises(OSError):
            jnative.parse_fastx(path)
        with pytest.raises(OSError):
            jfastq.read_reads(path)
        with pytest.raises((zlib.error, OSError)):
            fastq.read_reads(path)
        return
    want = jnative.parse_fastx(path)
    assert want is not None
    _assert_same(want, jfastq.read_reads(path))
    got = fastq.read_reads(path)
    _assert_same(got, want)
    inflated = bytes(native.read_bytes(path))
    assert data.startswith(inflated)
    cut = form == 'first_half'
    assert (len(inflated) < len(data)) == cut
    assert 0 < got.n <= 200 and (got.n < 200) == cut


def test_corrupt_gzip_raises_naming_the_file(slice_fastq, built):
    """A failed CRC, and a later member with the gzip magic but a corrupt
    header, raise zlib.error naming the path; fslr_tpu raises on both."""
    root, data = slice_fastq
    head = gzip_members(data[:data.index(b'@r1\n')])
    for name, blob in (('crc', gzip_forms(data)['bad_crc']),
                       ('member', head + b'\x1f\x8b\x09' + bytes(20))):
        path = str(root / f'corrupt_{name}.fq.gz')
        with open(path, 'wb') as fh:
            fh.write(blob)
        with pytest.raises(zlib.error, match=path):
            fastq.read_reads(path)
        with pytest.raises(OSError):
            jfastq.read_reads(path)


@pytest.mark.parametrize('chunk', [1, 2, 7, 1 << 22])
@pytest.mark.parametrize('after', ['', 'one_byte', 'magic_only', 'zeros'])
def test_gzip_members_read_in_chunks(slice_fastq, built, monkeypatch,
                                     chunk, after):
    """Chunks that split the magic or a member give fslr_tpu's arrays:
    three members, then nothing, one byte, a member's magic alone (gzread
    starts a member and finds the input cut) or zeros."""
    root, data = slice_fastq
    tail = {'': b'', 'one_byte': b'\x1f', 'magic_only': b'\x1f\x8b',
            'zeros': bytes(9)}[after]
    path = str(root / f'chunks_{chunk}_{after}.fq.gz')
    with open(path, 'wb') as fh:
        fh.write(gzip_members(data[:data.index(b'@r3\n')], 3) + tail)
    monkeypatch.setattr(native, '_GZ_CHUNK', chunk)
    got = fastq.read_reads(path)
    assert got.n == 3
    want = jnative.parse_fastx(path)
    assert want is not None
    _assert_same(got, want)


def _native_digests() -> dict:
    out = {}
    for name in sorted(os.listdir(os.path.join(REPO, 'native'))):
        with open(os.path.join(REPO, 'native', name), 'rb') as fh:
            out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_library_is_the_ports_own_build(tmp_path):
    """The loaded library lies under fslr_tpu_torch/_build/, and a parse
    leaves the JAX package's native/ tree as it was."""
    before = _native_digests()
    fastq.read_reads(_write(tmp_path, 'r.fastq.gz', gzip.compress(FASTQ)))
    build_dir = os.path.join(REPO, 'fslr_tpu_torch', '_build') + os.sep
    assert native.loaded_path().startswith(build_dir)
    assert native.loaded_path() == native.library_path()
    assert _native_digests() == before
    assert set(before) == {'Makefile', 'fslr_native.cpp',
                           'libfslr_native.so'}


def test_library_builds_both_sources(tmp_path, monkeypatch):
    """One g++ call compiles fastx.cpp and tsv.cpp into one library, which
    binds the parser's and the table reader's entry points."""
    assert [os.path.basename(s) for s in native.SOURCES] == ['fastx.cpp',
                                                             'tsv.cpp']
    _unbuilt(monkeypatch, tmp_path)
    calls = []
    run = native.subprocess.run

    def recorded(cmd, **kw):
        calls.append(cmd)
        return run(cmd, **kw)
    monkeypatch.setattr(native.subprocess, 'run', recorded)
    lib = native.library()
    assert len(calls) == 1 and calls[0][-2:] == list(native.SOURCES)
    assert lib.fslr_fastx_parse and lib.fslr_tsv_parse
    assert native.loaded_path() == native.library_path()
    table = native.TsvTable(bytearray(b'a\tb\n1\tx\n'), 'pyarrow', 1 << 20)
    with table:
        assert table.rectangular and table.kinds == [native.TSV_INT,
                                                     native.TSV_STR]


@pytest.mark.parametrize('which', [0, 1], ids=['fastx', 'tsv'])
def test_library_path_hashes_each_source(tmp_path, monkeypatch, which):
    """A change to either source names another library."""
    before = native.library_path()
    srcs = list(native.SOURCES)
    changed = tmp_path / os.path.basename(srcs[which])
    with open(srcs[which], 'rb') as fh:
        changed.write_bytes(fh.read() + b'\n// changed\n')
    srcs[which] = str(changed)
    monkeypatch.setattr(native, 'SOURCES', tuple(srcs))
    assert native.library_path() != before
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR


def _unbuilt(monkeypatch, tmp_path):
    """The parser unloaded and its build directory empty, under tmp_path."""
    monkeypatch.setattr(native, '_LIB', None)
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / '_build'))


def _missing_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native, 'CXX', str(tmp_path / 'no-such-g++'))
    return 'no-such-g++'


def _broken_source(monkeypatch, tmp_path):
    src = tmp_path / 'fastx.cpp'
    src.write_text('extern "C" int fslr_fastx_n(void* h) { return h; }\n')
    monkeypatch.setattr(native, 'SOURCES', (str(src), native.SOURCES[1]))
    return 'failed'


def _unloadable(monkeypatch, tmp_path):
    bad = tmp_path / 'not_a_library.so'
    bad.write_bytes(b'not an ELF file')
    monkeypatch.setattr(native, 'build', lambda: str(bad))
    return 'cannot load'


@pytest.mark.parametrize('fault', [_missing_compiler, _broken_source,
                                   _unloadable],
                         ids=['missing_compiler', 'compile_error',
                              'load_error'])
def test_failed_build_or_load_raises(tmp_path, monkeypatch, fault):
    """No fallback: the parse raises, and nothing is left loaded."""
    path = _write(tmp_path, 'r.fastq', FASTQ)
    _unbuilt(monkeypatch, tmp_path)
    said = fault(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match=said):
        fastq.read_reads(path)
    assert native.loaded_path() is None
    assert not list(tmp_path.glob('_build/*.tmp'))


def test_threads_build_one_library(tmp_path, monkeypatch):
    """Threads that parse at once on an empty build directory build once
    and all get the same arrays."""
    path = _write(tmp_path, 'r.fastq', FASTQ)
    _unbuilt(monkeypatch, tmp_path)
    n = 2 * (os.cpu_count() or 4)
    out, errors = [None] * n, []

    def parse(i):
        try:
            out[i] = fastq.read_reads(path)
        except Exception as e:             # reported below
            errors.append(e)
    threads = [threading.Thread(target=parse, args=(i,)) for i in range(n)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for fa in out[1:]:
        _assert_same(fa, out[0])
    assert os.listdir(tmp_path / '_build') == [
        os.path.basename(native.library_path())]


def test_plain_file_read_in_chunks(tmp_path, built, monkeypatch):
    """A plain file is read a chunk a call; chunks that split lines and
    records give the same arrays."""
    path = _write(tmp_path, 'r.fastq', FASTQ + SYMBOLS[:-1])
    whole = fastq.read_reads(path)
    monkeypatch.setattr(native, '_CHUNK', 7)
    _assert_same(fastq.read_reads(path), whole)
    _assert_same(whole, fastq.records_to_arrays(fastq._read_fastx_py(path)))


def test_gzip_is_told_by_its_magic_bytes(tmp_path, built):
    """A gzip file without the .gz suffix is inflated, as fslr_tpu's
    native reader (zlib's gzopen) does."""
    path = _write(tmp_path, 'r.fastq', gzip_members(FASTQ, 2))
    _assert_same(fastq.read_reads(path), jfastq.read_reads(path))
    assert fastq.read_reads(path).n == 3
