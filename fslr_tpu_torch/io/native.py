"""The port's host runtime: its FASTQ/FASTA parser (``csrc/fastx.cpp``)
and its tab-separated table reader (``csrc/tsv.cpp``), one library bound
with ctypes.

At first use one ``g++`` call compiles both sources into
``fslr_tpu_torch/_build/``, under a name that hashes the sources, the
flags and the host CPU
(``-march=native`` compiles for it), writing a temporary file that
``os.replace`` puts in place, so threads, processes and ranks that build
at once each get a whole library.  A failed build raises with the
compiler's output, a failed load with the loader's message: there is no
other parser or reader to fall back to.  Python reads the file and
inflates gzip; the C++ gets the bytes.  A gzip file is read as zlib's
``gzread`` reads it in ``fslr_tpu``'s parser (``gz_look``): member after
member while the bytes after one begin with the gzip magic, so text or
zero padding after the last member ends the input quietly, and a member
cut short yields what it inflated so far; corrupt deflate data or a
failed CRC or length check raises.  A table (:class:`TsvTable`) is read
from plain bytes the caller gives.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import zlib

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_PKG, 'csrc', f)
                for f in ('fastx.cpp', 'tsv.cpp'))
BUILD_DIR = os.path.join(_PKG, '_build')
CXX = 'g++'
CXX_FLAGS = ('-O3', '-march=native', '-fPIC', '-shared', '-std=c++17')

_LIB = None
_LOAD_LOCK = threading.Lock()
_CHUNK = 1 << 20          # plain files are read a MiB a call
_GZ_CHUNK = 1 << 22       # gzip files 4 MiB a call, as gzbuffer(f, 1 << 22)
_GZ_MAGIC = b'\x1f\x8b'

_DECODE = np.frombuffer(b'ACGTN', dtype=np.uint8)


def _host_cpu() -> bytes:
    """The CPU ``-march=native`` compiles for: /proc/cpuinfo's model name
    and flags of the first core, else the platform's processor name."""
    try:
        with open('/proc/cpuinfo', 'rb') as fh:
            first = fh.read().split(b'\n\n')[0].splitlines()
    except OSError:
        return platform.processor().encode()
    return b'\n'.join(ln for ln in first
                      if ln.startswith((b'model name', b'flags')))


def library_path() -> str:
    """Path of the library built from the current sources on this host
    (not built)."""
    h = hashlib.sha256(' '.join((CXX, *CXX_FLAGS)).encode())
    h.update(_host_cpu())
    for src in SOURCES:
        with open(src, 'rb') as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f'libfslr_host_{h.hexdigest()[:16]}.so')


def build() -> str:
    """Compile the library unless this host has a build of the same
    sources; returns its path.  Raises with the compiler's output if it
    fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{so}.{os.getpid()}.{threading.get_ident()}.tmp'
    try:
        res = subprocess.run([CXX, *CXX_FLAGS, '-o', tmp, *SOURCES],
                             capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f'the host runtime needs {CXX} to build '
                           f'{" ".join(SOURCES)}: {e}') from e
    if res.returncode:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f'{CXX} failed ({res.returncode}) on '
                           f'{" ".join(SOURCES)}:\n{res.stderr}')
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded library (built at first call; input files may be parsed
    on several threads, --procs: the first caller builds and binds, the
    others wait for its library)."""
    global _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            so = build()
            try:
                lib = ctypes.CDLL(so)
            except OSError as e:
                raise RuntimeError(f'cannot load the host runtime {so}: '
                                   f'{e}') from e
            lib.fslr_fastx_parse.restype = ctypes.c_void_p
            lib.fslr_fastx_parse.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            for fn in ('fslr_fastx_n', 'fslr_fastx_codes_len',
                       'fslr_fastx_names_len', 'fslr_fastx_quals_len',
                       'fslr_fastx_comments_len'):
                getattr(lib, fn).restype = ctypes.c_int64
                getattr(lib, fn).argtypes = [ctypes.c_void_p]
            lib.fslr_fastx_copy.restype = None
            lib.fslr_fastx_copy.argtypes = [ctypes.c_void_p] * 10
            lib.fslr_fastx_free.argtypes = [ctypes.c_void_p]
            _bind_tsv(lib)
            _LIB = lib
    return _LIB


def loaded_path() -> str | None:
    """Path of the library this process loaded, None before its first
    use."""
    return None if _LIB is None else _LIB._name


def _inflate(fh, path: str) -> bytearray:
    """Every gzip member of the open file ``fh`` (read from its start),
    inflated into one buffer as zlib's gzread does: after a member ends
    another is read only if the next bytes begin with the gzip magic
    (text or zeros after the last member end the input); the input ending
    inside a member keeps what was inflated; ``zlib.error`` (bad deflate
    data, CRC or length) raises, naming ``path``."""
    out = bytearray()
    member = zlib.decompressobj(wbits=31)      # one gzip member
    buf = fh.read(_GZ_CHUNK)
    while buf:
        try:
            out += member.decompress(buf)
        except zlib.error as e:
            raise zlib.error(f'{path}: {e}') from e
        if not member.eof:
            buf = fh.read(_GZ_CHUNK)
            continue
        buf = member.unused_data
        while len(buf) < 2:
            more = fh.read(_GZ_CHUNK)
            if not more:
                break
            buf += more
        if buf[:2] != _GZ_MAGIC:
            break
        member = zlib.decompressobj(wbits=31)
    return out


def read_bytes(path: str) -> bytearray:
    """The bytes the parser takes from ``path``: a gzip file's (told by
    its magic bytes, as zlib's gzopen does) inflated by :func:`_inflate`,
    a plain file's as they are."""
    with open(path, 'rb', buffering=0) as fh:
        if fh.read(2) == _GZ_MAGIC:
            fh.seek(0)
            return _inflate(fh, path)
        size = os.fstat(fh.fileno()).st_size
        fh.seek(0)
        buf = bytearray(size)
        got = 0
        with memoryview(buf) as view:
            while got < size:
                n = fh.readinto(view[got:got + _CHUNK])
                if not n:
                    break
                got += n
    del buf[got:]
    return buf


class FastxArrays:
    """Columnar parse result: encoded codes + offsets, zero per-read
    Python string work until a string is actually requested."""

    __slots__ = ('n', 'codes', 'lower', 'seq_off', '_names', 'name_off',
                 '_quals', 'qual_off', '_comments', 'comment_off')

    def __init__(self, n, codes, lower, seq_off, names, name_off, quals,
                 qual_off, comments, comment_off):
        self.n = n
        self.codes = codes
        self.lower = lower
        self.seq_off = seq_off
        self._names = names
        self.name_off = name_off
        self._quals = quals
        self.qual_off = qual_off
        self._comments = comments
        self.comment_off = comment_off

    def name(self, i: int) -> str:
        return self._names[self.name_off[i]:self.name_off[i + 1]].decode()

    def qual(self, i: int) -> str | None:
        if len(self._quals) == 0:
            return None
        q = self._quals[self.qual_off[i]:self.qual_off[i + 1]]
        return q.decode() if q else None

    def comment(self, i: int) -> str | None:
        c = self._comments[self.comment_off[i]:self.comment_off[i + 1]]
        return c.decode() if c else None

    def seq_codes(self, i: int) -> np.ndarray:
        return self.codes[self.seq_off[i]:self.seq_off[i + 1]]

    def lower_mask(self, i: int) -> np.ndarray:
        return self.lower[self.seq_off[i]:self.seq_off[i + 1]]

    def length(self, i: int) -> int:
        return int(self.seq_off[i + 1] - self.seq_off[i])

    def lengths(self) -> np.ndarray:
        return np.diff(self.seq_off)

    def seq_str(self, i: int, lower: np.ndarray | None = None) -> str:
        """Decode read ``i`` to a string; ``lower`` overrides the stored
        lowercase mask (e.g. the filter stage's computed repeat mask)."""
        codes = self.seq_codes(i)
        raw = _DECODE[codes]
        m = self.lower_mask(i) if lower is None else lower[:len(raw)]
        if m is not None and len(m) and m.any():
            raw = raw | (m.astype(np.uint8) << 5)
        return raw.tobytes().decode('ascii')

    def seq_strs(self, lo: int = 0, hi: int | None = None) -> list[str]:
        """Decode reads [lo, hi) to strings in ONE pass over the columnar
        buffers (per-read numpy decode cost ~0.3 ms/read in the align
        loop at 100k reads)."""
        hi = self.n if hi is None else hi
        b0, b1 = int(self.seq_off[lo]), int(self.seq_off[hi])
        raw = _DECODE[self.codes[b0:b1]]
        lw = self.lower[b0:b1]
        if len(lw) and lw.any():
            raw = raw | (lw.astype(np.uint8) << 5)
        buf = raw.tobytes()
        off = self.seq_off
        return [buf[int(off[i]) - b0:int(off[i + 1]) - b0]
                .decode('ascii') for i in range(lo, hi)]

    def qual_strs(self, lo: int = 0, hi: int | None = None) -> list:
        hi = self.n if hi is None else hi
        if len(self._quals) == 0:
            return [None] * (hi - lo)
        off = self.qual_off
        return [self._quals[int(off[i]):int(off[i + 1])].decode()
                or None for i in range(lo, hi)]

    def name_strs(self, lo: int = 0, hi: int | None = None) -> list[str]:
        hi = self.n if hi is None else hi
        off = self.name_off
        return [self._names[int(off[i]):int(off[i + 1])].decode()
                for i in range(lo, hi)]

    def codes_slice(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        """(cat, off) columnar code view of reads [lo, hi) — feeds the
        align stage without a string decode/re-encode round trip."""
        b0 = int(self.seq_off[lo])
        return (self.codes[b0:int(self.seq_off[hi])],
                (self.seq_off[lo:hi + 1] - b0).astype(np.int64))

    def subset(self, idx, lower_override: list | None = None):
        """New FastxArrays holding rows ``idx`` (in the given order).
        ``lower_override[j]`` replaces row ``idx[j]``'s lowercase mask."""
        idx = list(idx)
        codes_l, lower_l, names_l, quals_l, comments_l = [], [], [], [], []
        for j, i in enumerate(idx):
            c = self.seq_codes(i)
            codes_l.append(c)
            m = (lower_override[j] if lower_override is not None
                 else self.lower_mask(i))
            m = np.asarray(m, np.uint8)
            # lower shares seq_off with codes, so each row's mask MUST be
            # exactly read-length: overrides computed on padded length
            # buckets would shift every later row's mask otherwise
            if len(m) != len(c):
                mm = np.zeros(len(c), np.uint8)
                mm[:min(len(m), len(c))] = m[:len(c)]
                m = mm
            lower_l.append(m)
            names_l.append(self._names[self.name_off[i]:
                                       self.name_off[i + 1]])
            if len(self._quals):
                quals_l.append(self._quals[self.qual_off[i]:
                                           self.qual_off[i + 1]])
            else:
                quals_l.append(b'')
            comments_l.append(self._comments[self.comment_off[i]:
                                             self.comment_off[i + 1]])

        def _cat(parts):
            off = np.zeros(len(parts) + 1, np.int64)
            if parts:
                np.cumsum([len(p) for p in parts], out=off[1:])
            if off[-1] == 0:
                return np.zeros(0, np.uint8), off
            arrs = [np.frombuffer(p, np.uint8)
                    if isinstance(p, bytes) else p
                    for p in parts if len(p)]
            return np.concatenate(arrs), off

        codes, seq_off = _cat(codes_l)
        lower, _ = _cat(lower_l)
        names, name_off = _cat(names_l)
        quals, qual_off = _cat(quals_l)
        comments, comment_off = _cat(comments_l)
        has_qual = len(self._quals) > 0
        return FastxArrays(len(idx), codes, lower, seq_off,
                           names.tobytes(), name_off,
                           quals.tobytes() if has_qual else b'', qual_off,
                           comments.tobytes(), comment_off)


def parse_fastx(path: str) -> FastxArrays:
    """Native parse of a FASTQ/FASTA file, plain or gzip."""
    lib = library()
    data = np.frombuffer(read_bytes(path), np.uint8)
    h = lib.fslr_fastx_parse(data.ctypes.data, data.size)
    if not h:
        raise MemoryError(f'{path}: the FASTX parser ran out of memory')
    try:
        n = lib.fslr_fastx_n(h)
        ncodes = lib.fslr_fastx_codes_len(h)
        nnames = lib.fslr_fastx_names_len(h)
        nquals = lib.fslr_fastx_quals_len(h)
        ncom = lib.fslr_fastx_comments_len(h)
        codes = np.empty(ncodes, np.uint8)
        lower = np.empty(ncodes, np.uint8)
        seq_off = np.empty(n + 1, np.int64)
        names = np.empty(nnames, np.uint8)
        name_off = np.empty(n + 1, np.int64)
        quals = np.empty(max(nquals, 1), np.uint8)
        qual_off = np.empty(n + 1, np.int64)
        comments = np.empty(max(ncom, 1), np.uint8)
        comment_off = np.empty(n + 1, np.int64)
        lib.fslr_fastx_copy(
            h,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lower.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            seq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            names.ctypes.data_as(ctypes.c_char_p),
            name_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            quals.ctypes.data_as(ctypes.c_char_p),
            qual_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            comments.ctypes.data_as(ctypes.c_char_p),
            comment_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return FastxArrays(int(n), codes, lower, seq_off,
                           names.tobytes(), name_off,
                           quals.tobytes()[:nquals], qual_off,
                           comments.tobytes()[:ncom], comment_off)
    finally:
        lib.fslr_fastx_free(h)


# ---------------------------------------------------------------------------
# Tab-separated tables (csrc/tsv.cpp)
# ---------------------------------------------------------------------------

# column kinds of fslr_tsv_kind, and the numpy type fslr_tsv_fill writes
TSV_INT, TSV_INT_NA, TSV_FLOAT, TSV_BOOL, TSV_BOOL_NA, TSV_STR, TSV_CELLS = \
    range(7)
_TSV_FILL = {TSV_INT: np.int64, TSV_INT_NA: np.float64,
             TSV_FLOAT: np.float64, TSV_BOOL: np.bool_,
             TSV_BOOL_NA: np.uint8, TSV_STR: np.int64, TSV_CELLS: np.int64}


def _bind_tsv(lib: ctypes.CDLL) -> None:
    h, i64, p = ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p
    for fn, res, args in (
            ('fslr_tsv_parse', h, [p, i64, i64, i64]),
            ('fslr_tsv_status', i64, [h]), ('fslr_tsv_ncols', i64, [h]),
            ('fslr_tsv_nrows', i64, [h]), ('fslr_tsv_kind', i64, [h, i64]),
            ('fslr_tsv_header_bytes', i64, [h]),
            ('fslr_tsv_header', None, [h, p]),
            ('fslr_tsv_fill', i64, [h, i64, p]),
            ('fslr_tsv_dict_bytes', i64, [h, i64]),
            ('fslr_tsv_dict', None, [h, i64, p]),
            ('fslr_tsv_free', None, [h])):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args


class TsvTable:
    """A tab-separated file's bytes tokenized and each column classified
    by ``csrc/tsv.cpp`` (``csv.reader(delimiter='\\t')``'s fields, typed as
    ``stages/cluster._parse_column`` types them for ``engine``, 'c' or
    'pyarrow').  ``rectangular`` is False where the bytes are no
    rectangle of cells (a blank line, a ragged row, a stray quote, no
    header ...): read such a file with the csv module.  Quoted fields are
    unescaped in ``data``, which the table keeps until :meth:`close`.
    Strings come as bytes joined by NUL, which no table holds: decode and
    split them."""

    def __init__(self, data: bytearray, engine: str, field_limit: int):
        self._lib = library()
        self._data = np.frombuffer(data, np.uint8)    # writable, pinned
        self._h = self._lib.fslr_tsv_parse(
            self._data.ctypes.data, self._data.size,
            int(engine == 'pyarrow'), field_limit)
        if not self._h:
            raise MemoryError('the table reader ran out of memory')
        self.rectangular = self._lib.fslr_tsv_status(self._h) == 0
        self.ncols = self._lib.fslr_tsv_ncols(self._h)
        self.nrows = self._lib.fslr_tsv_nrows(self._h)
        self.kinds = [self._lib.fslr_tsv_kind(self._h, j)
                      for j in range(self.ncols)]

    def header(self) -> bytes:
        """The header's cells, joined by NUL."""
        buf = ctypes.create_string_buffer(
            self._lib.fslr_tsv_header_bytes(self._h))
        self._lib.fslr_tsv_header(self._h, buf)
        return buf.raw

    def column(self, j: int) -> tuple[np.ndarray, bytes | None]:
        """Column ``j``'s values as ``kinds[j]`` has them (TSV_BOOL_NA:
        0 False, 1 True, 2 missing); for TSV_STR and TSV_CELLS the codes
        of its cells and its distinct cells in code order (first seen
        first), joined by NUL."""
        out = np.empty(self.nrows, _TSV_FILL[self.kinds[j]])
        k = self._lib.fslr_tsv_fill(self._h, j, out.ctypes.data)
        if k < 0:
            raise MemoryError('the table reader ran out of memory')
        if self.kinds[j] not in (TSV_STR, TSV_CELLS):
            return out, None
        buf = ctypes.create_string_buffer(
            self._lib.fslr_tsv_dict_bytes(self._h, j))
        self._lib.fslr_tsv_dict(self._h, j, buf)
        return out, buf.raw

    def close(self) -> None:
        if self._h:
            self._lib.fslr_tsv_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
