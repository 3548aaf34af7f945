"""Reference genome loading and the k-mer seed index, built on a device.

Replaces the reference pipeline's ``bwa index`` + FM-index seeding
(fslr/main.py:125 ``bwa mem -k 11``, fslr/make_ref_mask.py:19) with a
flat sorted k-mer -> positions table that the aligner queries with
gathers (ops/seed.py).  Seed length k mirrors bwa's ``-k 11``
(config.AlignConfig.seed_k); k-mers containing N are excluded.  The index
is built with torch ops on the caller's device and kept as numpy arrays,
the form of the ``.npz`` cache that fslr_tpu also reads and writes; a
genome above ``MAX_UNSHARDED_BASES`` is cut into contig-aligned shards.

Also provides the masked-reference builder (make_ref_mask.py:5-19
semantics): one region per chromosome, N-padding before the region start,
region sequence afterwards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip

import numpy as np
import torch

from fslr_tpu_torch.encode import _ENC_ANYCASE, encode
from fslr_tpu_torch.io.fastq import read_fastx


@dataclasses.dataclass
class Reference:
    names: list[str]                 # contig names, FASTA order
    lengths: np.ndarray              # (n_contigs,) int64
    offsets: np.ndarray              # (n_contigs + 1,) int64 concat offsets
    codes: np.ndarray                # (total_len,) uint8 concatenated 2bit+N

    def contig_of(self, gpos):
        """Map global concat positions -> (contig index, local pos)."""
        ci = np.searchsorted(self.offsets, gpos, side='right') - 1
        return ci, gpos - self.offsets[ci]


@dataclasses.dataclass
class SeedIndex:
    k: int
    counts: np.ndarray               # (4^k + 1,) int64 cumulative offsets
    positions: np.ndarray            # (n_seeds,) int32 shard-local positions
    shards: list | None = None       # [IndexShard] when the genome exceeds
                                     # MAX_UNSHARDED_BASES (then counts/
                                     # positions above are empty)


@dataclasses.dataclass
class IndexShard:
    """One contig-aligned slice of a large genome with its own int32
    index.  Device arrays (genome codes, k-mer tables) stay int32-safe
    per shard; alignments are remapped to parent contig ids by
    ``contig_base``."""
    ref: Reference
    sidx: SeedIndex
    contig_base: int


# Per-shard cap: device seeding uses int32 positions and a 2^30 sentinel
# (ops/seed.py BIG), so every shard-local position — and hence every
# diagonal — must stay below 2^30.  Genomes above this (e.g. GRCh38 at
# 3.1 Gbp) are sharded at contig boundaries.
MAX_UNSHARDED_BASES = 2 ** 30 - 2 ** 26


def load_reference(path: str, names=None) -> Reference:
    """The contigs of a FASTA (or FASTQ) file, optionally gzipped, encoded;
    with ``names``, only the contigs of those names.

    A FASTA is parsed in bulk: one read of the file, its line ends made
    newlines as text mode makes them, each contig's newlines dropped and
    bases encoded in one ``bytes.translate``.  Anything else goes record
    by record through ``read_fastx``.  Both give the names and codes of
    ``read_fastx`` + ``encode`` (tests/test_torch_index.py)."""
    with (gzip.open if path.endswith('.gz') else open)(path, 'rb') as fh:
        data = fh.read()
    if data[:1] == b'>':
        if b'\r' in data:
            data = data.replace(b'\r\n', b'\n').replace(b'\r', b'\n')
        contigs = _fasta_contigs(data, names)
    else:
        contigs = ((rec.name, encode(rec.sequence))
                   for rec in read_fastx(path)
                   if names is None or rec.name in names)
    contigs = list(contigs)
    del data
    parts = [c for _, c in contigs]
    lengths = np.array([len(p) for p in parts], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    codes = (np.concatenate(parts) if parts
             else np.zeros(0, dtype=np.uint8))
    return Reference(names=[n for n, _ in contigs], lengths=lengths,
                     offsets=offsets, codes=codes)


_TRANSLATE = _ENC_ANYCASE.tobytes()


def _fasta_contigs(data: bytes, names=None):
    """(name, codes) of every record of a FASTA held in ``data`` with
    newline line ends (of those named ``names``): a record starts at a
    line beginning with '>', its name is the header up to the first space
    (else tab), its sequence every later line up to the next record,
    newlines removed.  A sequence byte outside ASCII raises, as
    ``encode`` does."""
    head = 0
    while head >= 0:
        nl = data.find(b'\n', head)
        nl = len(data) if nl < 0 else nl
        nxt = data.find(b'\n>', nl)
        end = len(data) if nxt < 0 else nxt + 1
        line = data[head + 1:nl].decode()
        name = line.split(' ' if ' ' in line else '\t', 1)[0]
        if names is None or name in names:
            seq = data[nl + 1:end]
            if not seq.isascii():
                raise ValueError(f'contig {name}: a byte outside ASCII')
            yield name, np.frombuffer(seq.translate(_TRANSLATE, b'\n'),
                                      np.uint8)
        head = end if nxt >= 0 else -1


def build_seed_index(ref: Reference, k: int, device: torch.device,
                     max_shard_bases: int = MAX_UNSHARDED_BASES,
                     timer=None) -> SeedIndex:
    """The sorted k-mer -> positions index of ``ref``, built on ``device``.

    Equal to ``fslr_tpu.index.reference.build_seed_index``: ``counts`` the
    cumulative k-mer offsets (int64, 4^k + 1), ``positions`` the start of
    every k-mer without an N and inside one contig (int32), sorted by
    k-mer and ascending within one.  A genome above ``max_shard_bases``
    with more than one contig is cut at contig boundaries into shards of
    at most that size, each with its own index, built one after another.
    ``timer`` (a StageTimer) gets each build's seconds as ``index_build``
    (``index_build_shard{i}`` for shard i)."""
    if len(ref.codes) > max_shard_bases and len(ref.names) > 1:
        shards = []
        for si, (c0, c1) in enumerate(
                shard_contig_ranges(ref.lengths, max_shard_bases)):
            sref = sub_reference(ref, c0, c1)
            with _timed(timer, f'index_build_shard{si}', device):
                counts, positions = _kmer_index(sref, k, device)
            shards.append(IndexShard(
                ref=sref, contig_base=c0,
                sidx=SeedIndex(k=k, counts=counts, positions=positions)))
        return SeedIndex(k=k, counts=np.zeros(0, np.int64),
                         positions=np.zeros(0, np.int32), shards=shards)
    with _timed(timer, 'index_build', device):
        counts, positions = _kmer_index(ref, k, device)
    return SeedIndex(k=k, counts=counts, positions=positions)


@contextlib.contextmanager
def _timed(timer, name: str, device: torch.device):
    if timer is None:
        yield
        return
    with timer.stage(name):
        yield
        if device.type == 'cuda':
            torch.cuda.synchronize(device)


def _kmer_index(ref: Reference, k: int, device: torch.device):
    """(counts, positions) of one unsharded reference as numpy arrays.

    Each k-mer's code is built in place from the k shifted base slices; a
    k-mer holding an N or crossing a contig boundary gets the code 4^k,
    which sorts after every real one.  One stable sort of the codes gives
    the positions (its indices) in k-mer order and ascending within a
    k-mer, and a search of the sorted codes for 0..4^k the cumulative
    counts.  Device memory peaks in the sort, at about 36 bytes a base."""
    n = len(ref.codes) - k + 1
    if n <= 0:
        return np.zeros(4 ** k + 1, np.int64), np.zeros(0, np.int32)
    absent = 4 ** k
    dtype = torch.int32 if absent < 2 ** 31 else torch.int64
    codes = torch.from_numpy(np.ascontiguousarray(ref.codes)).to(device)
    kmers = torch.zeros(n, dtype=dtype, device=device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    for p in range(k):
        c = codes[p:p + n]
        ok = c < 4
        kmers.mul_(4).add_(c.masked_fill(~ok, 0))
        valid &= ok
    del codes, c, ok
    for off in ref.offsets[1:-1].tolist():
        valid[max(0, off - k + 1):off] = False
    kmers.masked_fill_(~valid, absent)
    del valid
    ordered, order = torch.sort(kmers, stable=True)
    del kmers
    counts = torch.searchsorted(
        ordered, torch.arange(absent + 1, dtype=dtype, device=device))
    del ordered
    positions = order[:int(counts[-1])].to(torch.int32)
    del order
    out = counts.cpu().numpy(), positions.cpu().numpy()
    del counts, positions
    if device.type == 'cuda':
        # hand the sort's cached memory back: later calls size themselves
        # by the card's free memory
        torch.cuda.empty_cache()
    return out


def shard_contig_ranges(lengths, max_shard_bases: int = MAX_UNSHARDED_BASES
                        ) -> list[tuple[int, int]]:
    """Greedy contig packing: consecutive [c0, c1) ranges whose total
    length stays under the shard cap."""
    ranges = []
    c0, total = 0, 0
    for ci, ln in enumerate(lengths):
        ln = int(ln)
        if ln > 2 ** 30 - 2 ** 8:
            raise ValueError(
                f'contig {ci} is {ln} bp — larger than a device shard')
        if total + ln > max_shard_bases and total > 0:
            ranges.append((c0, ci))
            c0, total = ci, 0
        total += ln
    if total > 0 or not ranges:
        ranges.append((c0, len(lengths)))
    return ranges


def sub_reference(ref: Reference, c0: int, c1: int) -> Reference:
    """Contig range [c0, c1) as a Reference; codes is a view (no copy)."""
    base = int(ref.offsets[c0])
    return Reference(
        names=ref.names[c0:c1],
        lengths=ref.lengths[c0:c1],
        offsets=ref.offsets[c0:c1 + 1] - base,
        codes=ref.codes[base:int(ref.offsets[c1])])


def write_masked_reference(mask_bed: str, out_path: str, ref_path: str):
    """Masked-reference FASTA with the reference's exact layout
    (make_ref_mask.py:5-19): per bed line ``chrom start end``, emit a contig
    named ``chrom`` consisting of (start-1) Ns followed by ref[start:end]
    (0-based half-open fetch, as pysam.FastaFile.fetch).  Only the
    reference's contigs that the BED names are read."""
    with open(mask_bed) as f:
        chroms = {line.split('\t')[0] for line in f}
    ref = load_reference(ref_path, names=chroms)
    name_to_idx = {n: i for i, n in enumerate(ref.names)}
    from fslr_tpu_torch.encode import decode
    with open(mask_bed) as f, open(out_path, 'w') as out:
        for line in f:
            if line.startswith('#'):
                continue
            fields = line.strip().split('\t')
            if len(fields) < 3:
                continue
            chrom, start, end = fields[0], int(fields[1]), int(fields[2])
            ci = name_to_idx[chrom]
            lo = ref.offsets[ci]
            seq = decode(ref.codes[lo + start:lo + end])
            out.write(f'>{chrom}\n')
            if start > 0:
                out.write('N' * (start - 1))
            out.write(seq)
            out.write('\n')
