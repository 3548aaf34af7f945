"""FASTQ / FASTA reading and writing (host I/O edge).

Self-contained replacement for the reference's pysam.FastxFile usage
(fslr/filter_junk_from_fq.py:125, fslr/find_reads_with_primers.py:79): parses
FASTQ and FASTA, transparently decompresses ``.gz``, and renders records back
in the same format pysam does (``@name comment\\nseq\\n+\\nqual`` for FASTQ,
``>name comment\\nseq`` for FASTA), which is what the reference writes with
``str(record)``.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os
from typing import Iterable, Iterator


@dataclasses.dataclass
class FastxRecord:
    name: str
    sequence: str
    quality: str | None = None     # None for FASTA records
    comment: str | None = None

    def __str__(self) -> str:
        head = self.name if not self.comment else f'{self.name} {self.comment}'
        if self.quality is None:
            return f'>{head}\n{self.sequence}'
        return f'@{head}\n{self.sequence}\n+\n{self.quality}'

    def __len__(self) -> int:
        return len(self.sequence)


def _open_text(path: str) -> io.TextIOBase:
    if path.endswith('.gz'):
        return io.TextIOWrapper(
            io.BufferedReader(gzip.open(path, 'rb'), buffer_size=1 << 20))
    return open(path, 'rt', buffering=1 << 20)


def _split_header(line: str) -> tuple[str, str | None]:
    head = line[1:].rstrip('\n')
    if ' ' in head:
        name, comment = head.split(' ', 1)
        return name, comment
    if '\t' in head:
        name, comment = head.split('\t', 1)
        return name, comment
    return head, None


def read_fastx(path: str) -> Iterator[FastxRecord]:
    """Iterate string records from a FASTQ/FASTA file (optionally gzipped).

    This is the string-record interface; batch consumers use
    :func:`read_reads` (columnar, zero per-read string work).  Pure-Python
    parse: materializing strings from the native parser costs more than
    parsing them directly.
    """
    yield from _read_fastx_py(path)


def read_reads(path: str):
    """Columnar read of a FASTQ/FASTA file -> :class:`FastxArrays`.

    Default path for the stages: the native C++ parser (zlib for .gz,
    encoded codes + lowercase mask straight into numpy arrays, no per-read
    Python strings).  Falls back transparently to the pure-Python parser
    when the native library can't build/load (set ``FSLR_NO_NATIVE=1`` to
    force the fallback).  The native parser normalizes non-ACGTN symbols
    to N; the fallback applies the same encoding, so stage decisions are
    identical on either path.
    """
    if not os.environ.get('FSLR_NO_NATIVE'):
        try:
            from fslr_tpu_torch.io.native import parse_fastx
            fa = parse_fastx(path)
        except Exception as e:
            import sys
            print(f'WARNING: native FASTX parser failed on {path} '
                  f'({type(e).__name__}: {e}); using the Python parser',
                  file=sys.stderr)
            fa = None
        if fa is not None:
            return fa
    return records_to_arrays(_read_fastx_py(path))


def records_to_arrays(records: Iterable[FastxRecord]):
    """Build a :class:`FastxArrays` from string records (the non-native
    constructor; also used to columnarize in-memory record lists)."""
    import numpy as np

    from fslr_tpu_torch.encode import encode, lowercase_mask
    from fslr_tpu_torch.io.native import FastxArrays

    codes_l, lower_l, names_l, quals_l, comments_l = [], [], [], [], []
    for rec in records:
        codes_l.append(encode(rec.sequence))
        lower_l.append(lowercase_mask(rec.sequence).astype(np.uint8))
        names_l.append(rec.name.encode())
        quals_l.append((rec.quality or '').encode())
        comments_l.append((rec.comment or '').encode())

    def _cat(parts):
        off = np.zeros(len(parts) + 1, np.int64)
        if parts:
            np.cumsum([len(p) for p in parts], out=off[1:])
        if off[-1] == 0:
            return np.zeros(0, np.uint8), off
        arrs = [np.frombuffer(p, np.uint8) if isinstance(p, bytes) else p
                for p in parts if len(p)]
        return np.concatenate(arrs), off

    codes, seq_off = _cat(codes_l)
    lower, _ = _cat(lower_l)
    names, name_off = _cat(names_l)
    quals, qual_off = _cat(quals_l)
    comments, comment_off = _cat(comments_l)
    has_qual = any(len(q) for q in quals_l)
    return FastxArrays(len(codes_l), codes, lower, seq_off,
                       names.tobytes(), name_off,
                       quals.tobytes() if has_qual else b'', qual_off,
                       comments.tobytes(), comment_off)


def _read_fastx_py(path: str) -> Iterator[FastxRecord]:
    with _open_text(path) as fh:
        first = fh.read(1)
        if not first:
            return
        if first == '@':
            # FASTQ
            line = first + fh.readline()
            while line:
                name, comment = _split_header(line)
                seq = fh.readline().rstrip('\n')
                fh.readline()  # '+'
                qual = fh.readline().rstrip('\n')
                yield FastxRecord(name=name, sequence=seq, quality=qual,
                                  comment=comment)
                line = fh.readline()
        elif first == '>':
            line = first + fh.readline()
            while line:
                name, comment = _split_header(line)
                parts = []
                line = fh.readline()
                while line and not line.startswith('>'):
                    parts.append(line.rstrip('\n'))
                    line = fh.readline()
                yield FastxRecord(name=name, sequence=''.join(parts),
                                  quality=None, comment=comment)
        else:
            raise ValueError(f'{path}: not FASTA/FASTQ (starts with {first!r})')


def write_fastx(path: str, records: Iterable[FastxRecord]) -> int:
    n = 0
    with open(path, 'w', buffering=1 << 20) as fh:
        for rec in records:
            fh.write(str(rec))
            fh.write('\n')
            n += 1
    return n


def glob_input_files(folder: str) -> list[str]:
    """Input file discovery with the same extension set and glob ordering as
    the reference (fslr/main.py:85-87)."""
    import glob as _glob
    exts = ['*.fq.gz', '*.fq', '*.fastq.gz', '*.fastq', '*.fasta', '*.fa',
            '*.fasta.gz', '*.fa.gz']
    out: list[str] = []
    for e in exts:
        out.extend(_glob.glob(os.path.join(folder, e)))
    return out
