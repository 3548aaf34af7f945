"""Base encoding utilities: DNA strings <-> small-integer arrays.

Bases are encoded A=0, C=1, G=2, T=3, everything else (N, lowercase is
upcased first when requested) = 4.  Code 4 ("N") mismatches every base
including itself in alignment scoring, and participates in k-mer codes as a
fifth symbol so that the junk filter's k-mer statistics replicate the
reference's string-keyed dictionaries (fslr/filter_junk_from_fq.py:30-61,
which treat 'N' as an ordinary character).
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4
NUM_SYMBOLS = 5  # A C G T N

# byte -> code lookup (uppercase only; lowercase maps to N unless upcased)
_ENC = np.full(256, N, dtype=np.uint8)
for _i, _b in enumerate(b'ACGT'):
    _ENC[_b] = _i

_ENC_ANYCASE = _ENC.copy()
for _i, _b in enumerate(b'acgt'):
    _ENC_ANYCASE[_b] = _i

_DEC = np.frombuffer(b'ACGTN', dtype=np.uint8)

# complement in code space; N -> N
_COMP = np.array([T, G, C, A, N], dtype=np.uint8)

# byte-level lowercase test for tantan-style masked FASTA handling
_IS_LOWER = np.zeros(256, dtype=bool)
_IS_LOWER[ord('a'):ord('z') + 1] = True


def encode(seq: str | bytes, anycase: bool = True) -> np.ndarray:
    """Encode a DNA string to uint8 codes. ``anycase`` maps acgt like ACGT."""
    if isinstance(seq, str):
        seq = seq.encode('ascii')
    raw = np.frombuffer(seq, dtype=np.uint8)
    table = _ENC_ANYCASE if anycase else _ENC
    return table[raw]


def decode(codes: np.ndarray) -> str:
    return _DEC[np.asarray(codes, dtype=np.uint8)].tobytes().decode('ascii')


def revcomp_str(seq: str) -> str:
    """Reverse complement of a string (parity with fslr rev_comp, which only
    accepts ACGTN; here any other symbol becomes N)."""
    return decode(_COMP[encode(seq)][::-1])


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(codes, dtype=np.uint8)][::-1]


def comp(codes: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(codes, dtype=np.uint8)]


def lowercase_mask(seq: str | bytes) -> np.ndarray:
    """Boolean mask of lowercase positions (tantan marks repeats lowercase)."""
    if isinstance(seq, str):
        seq = seq.encode('ascii')
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _IS_LOWER[raw]


def pad_to(codes: np.ndarray, length: int, fill: int = N) -> np.ndarray:
    out = np.full(length, fill, dtype=np.uint8)
    out[:len(codes)] = codes[:length]
    return out


def bucket_length(n: int, buckets) -> int:
    """Smallest bucket >= n, or the largest bucket if n exceeds all."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def batch_encode(seqs, length: int, anycase: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Encode a list of strings into a padded (B, length) array + lengths."""
    batch = np.full((len(seqs), length), N, dtype=np.uint8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        codes = encode(s, anycase=anycase)[:length]
        batch[i, :len(codes)] = codes
        lens[i] = min(len(s), length)
    return batch, lens


def encode_cat(seqs, anycase: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Encode a list of strings into ONE concatenated uint8 code array plus
    (n+1,) int64 offsets — the struct-of-arrays read store used by the
    align stage (per-read Python encode/copy loops cost ~1 s per 10k reads
    there; this is one table lookup over the joined bytes)."""
    joined = ''.join(seqs).encode('ascii')
    raw = np.frombuffer(joined, dtype=np.uint8)
    table = _ENC_ANYCASE if anycase else _ENC
    cat = table[raw]
    off = np.zeros(len(seqs) + 1, np.int64)
    if seqs:
        np.cumsum(np.fromiter(map(len, seqs), np.int64, len(seqs)),
                  out=off[1:])
    return cat, off


def kmer_codes(codes: np.ndarray, k: int, base: int = NUM_SYMBOLS) -> np.ndarray:
    """Rolling k-mer integer codes (base-5 by default so N participates).

    Returns an int64 array of length ``len(codes) - k + 1`` (empty if shorter).
    Matches string-slice k-mers: code = sum(codes[i + p] * base**(k-1-p)).
    """
    codes = np.asarray(codes, dtype=np.int64)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for p in range(k):
        out = out * base + codes[p:p + n]
    return out
