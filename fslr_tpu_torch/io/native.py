"""ctypes bindings for the native host runtime (native/fslr_native.cpp).

Builds the shared library on first use if g++ is available; callers fall
back to the pure-Python reader when the library is unavailable, so the
package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB = None
_TRIED = False
_LOAD_LOCK = threading.Lock()

_DECODE = np.frombuffer(b'ACGTN', dtype=np.uint8)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), 'native')


def _load():
    # input files may be parsed on several threads (--procs): the first
    # caller builds and binds, the others wait for its library
    with _LOAD_LOCK:
        return _load_once()


def _load_once():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_NATIVE_DIR, 'libfslr_native.so')
    src = os.path.join(_NATIVE_DIR, 'fslr_native.cpp')
    stale = (os.path.exists(so) and os.path.exists(src)
             and os.path.getmtime(src) > os.path.getmtime(so))
    if not os.path.exists(so) or stale:
        try:
            if stale:
                os.remove(so)
            subprocess.run(['make', '-C', _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception as e:
            import sys
            if not os.path.exists(so):
                print(f'WARNING: native parser build failed '
                      f'({type(e).__name__}: {e}); falling back to the '
                      f'Python FASTQ parser', file=sys.stderr)
                return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.fslr_fastx_parse.restype = ctypes.c_void_p
    lib.fslr_fastx_parse.argtypes = [ctypes.c_char_p]
    for fn in ('fslr_fastx_n', 'fslr_fastx_codes_len',
               'fslr_fastx_names_len', 'fslr_fastx_quals_len',
               'fslr_fastx_comments_len'):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.fslr_fastx_copy.restype = None
    lib.fslr_fastx_copy.argtypes = [ctypes.c_void_p] * 10
    lib.fslr_fastx_free.argtypes = [ctypes.c_void_p]
    # emit-stream RLE decoder (older prebuilt .so may lack the symbols)
    try:
        lib.fslr_decode_emits.restype = ctypes.c_void_p
        lib.fslr_decode_emits.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.fslr_emits_total.restype = ctypes.c_int64
        lib.fslr_emits_total.argtypes = [ctypes.c_void_p]
        lib.fslr_emits_copy.restype = None
        lib.fslr_emits_copy.argtypes = [ctypes.c_void_p] * 4
        lib.fslr_emits_free.argtypes = [ctypes.c_void_p]
    except AttributeError:
        pass
    _LIB = lib
    return _LIB


def decode_emits(blocks: np.ndarray):
    """RLE-decode a (n, t4) block of 2-bit-packed emit rows natively.
    Returns (seg_off[n+1], seg_len, seg_op) int32/int32/uint8 arrays, or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, 'fslr_decode_emits'):
        return None
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    n, t4 = blocks.shape
    h = lib.fslr_decode_emits(
        blocks.ctypes.data_as(ctypes.c_void_p), n, t4)
    total = lib.fslr_emits_total(h)
    off = np.empty(n + 1, np.int32)
    seg_len = np.empty(total, np.int32)
    seg_op = np.empty(max(total, 1), np.uint8)
    lib.fslr_emits_copy(h, off.ctypes.data_as(ctypes.c_void_p),
                        seg_len.ctypes.data_as(ctypes.c_void_p),
                        seg_op.ctypes.data_as(ctypes.c_void_p))
    lib.fslr_emits_free(h)
    return off, seg_len, seg_op[:total]


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


def parse_fastx(path: str) -> FastxArrays | None:
    """Native parse; returns None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = lib.fslr_fastx_parse(path.encode())
    if not h:
        raise IOError(f'failed to read {path}')
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
