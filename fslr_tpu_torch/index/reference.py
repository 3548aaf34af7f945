"""Reference genome loading and k-mer seed index (host-built, numpy).

Replaces the reference pipeline's ``bwa index`` + FM-index seeding
(fslr/main.py:125 ``bwa mem -k 11``,
fslr/make_ref_mask.py:19) with a TPU-friendly design: a flat
sorted k-mer -> positions table, replicated per host, that the device
queries with pure gathers (ops/seed.py).  Seed length k mirrors bwa's
``-k 11`` (config.AlignConfig.seed_k); k-mers containing N are excluded.

Also provides the masked-reference builder (make_ref_mask.py:5-19
semantics): one region per chromosome, N-padding before the region start,
region sequence afterwards.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fslr_tpu_torch.encode import encode
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


def load_reference(path: str) -> Reference:
    names, parts = [], []
    for rec in read_fastx(path):
        names.append(rec.name)
        parts.append(encode(rec.sequence))
    lengths = np.array([len(p) for p in parts], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    codes = (np.concatenate(parts) if parts
             else np.zeros(0, dtype=np.uint8))
    return Reference(names=names, lengths=lengths, offsets=offsets,
                     codes=codes)


def packed_seed_table(sidx: SeedIndex, C: int) -> np.ndarray:
    """(4^k, 1 + C) int32 packed seed table: column 0 is each k-mer's
    occurrence count, columns 1..C its evenly sampled reference positions
    (same sampling as ops/seed.seed_candidates' legacy take: start +
    (ci * occ) // C when occ > C, else start + ci).  One device row
    gather replaces three scalar gathers in the seeding kernel.  Cached
    on the SeedIndex; callers gate by C (HBM cost is 4^k * (1+C) * 4 B —
    ~100 MB at C=5, so large-C repetitive-genome indexes keep the legacy
    counts/positions path)."""
    cached = getattr(sidx, '_packed_tab', None)
    if cached is not None and cached.shape[1] == C + 1:
        return cached
    counts = sidx.counts.astype(np.int64)
    occ = np.diff(counts)
    n = len(occ)
    starts = counts[:-1]
    pos = sidx.positions
    tab = np.zeros((n, C + 1), np.int32)
    tab[:, 0] = np.minimum(occ, 2 ** 31 - 1)
    use = np.minimum(occ, C)
    # hash-staggered sampling phase: without it every k-mer of a tandem
    # repeat samples the SAME C of occ copies, giving each sampled
    # copy-diagonal the repeat's full seed density and starving distinct
    # segments out of the candidate slots (tests/test_repetitive_recall);
    # a per-kmer phase spreads density evenly over all occ copies while
    # keeping every copy discoverable.  Mirrors ops/seed.seed_candidates'
    # counts-path sampling.
    step = np.maximum(occ // C, 1)
    # uint32 wraparound product, matching the kernel's jnp.uint32 hash
    phase = ((np.arange(n, dtype=np.uint32) * np.uint32(2654435761))
             >> np.uint32(20)).astype(np.int64) % step
    for ci in range(C):
        idx = starts + np.where(occ > C, (ci * occ) // C + phase, ci)
        v = pos[np.minimum(idx, max(len(pos) - 1, 0))]
        tab[:, 1 + ci] = np.where(ci < use, v, 0)
    sidx._packed_tab = tab
    return tab


def build_seed_index(ref: Reference, k: int,
                     max_shard_bases: int = MAX_UNSHARDED_BASES
                     ) -> SeedIndex:
    if len(ref.codes) > max_shard_bases and len(ref.names) > 1:
        return _build_sharded(ref, k, max_shard_bases)
    codes = ref.codes.astype(np.int64)
    n = len(codes) - k + 1
    if n <= 0:
        return SeedIndex(k=k, counts=np.zeros(4 ** k + 1, np.int64),
                         positions=np.zeros(0, np.int32))
    kdtype = np.int32 if 4 ** k < 2 ** 31 else np.int64
    kmers = np.zeros(n, dtype=kdtype)
    valid = np.ones(n, dtype=bool)
    for p in range(k):
        c = codes[p:p + n].astype(kdtype)
        kmers = kmers * 4 + np.where(c < 4, c, 0)
        valid &= c < 4
    # exclude k-mers spanning contig boundaries
    for off in ref.offsets[1:-1]:
        lo = max(0, off - k + 1)
        valid[lo:off] = False
    pos = np.nonzero(valid)[0]
    km = kmers[pos]
    order = np.argsort(km, kind='stable')
    positions = pos[order]
    counts = np.zeros(4 ** k + 1, dtype=np.int64)
    np.add.at(counts, km.astype(np.int64) + 1, 1)
    counts = np.cumsum(counts)
    return SeedIndex(k=k, counts=counts,
                     positions=positions.astype(np.int32))


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


def _build_sharded(ref: Reference, k: int, max_shard_bases: int
                   ) -> SeedIndex:
    shards = []
    for c0, c1 in shard_contig_ranges(ref.lengths, max_shard_bases):
        sref = sub_reference(ref, c0, c1)
        shards.append(IndexShard(ref=sref,
                                 sidx=build_seed_index(sref, k,
                                                       max_shard_bases),
                                 contig_base=c0))
    return SeedIndex(k=k, counts=np.zeros(0, np.int64),
                     positions=np.zeros(0, np.int32), shards=shards)


def write_masked_reference(mask_bed: str, out_path: str, ref_path: str):
    """Masked-reference FASTA with the reference's exact layout
    (make_ref_mask.py:5-19): per bed line ``chrom start end``, emit a contig
    named ``chrom`` consisting of (start-1) Ns followed by ref[start:end]
    (0-based half-open fetch, as pysam.FastaFile.fetch)."""
    ref = load_reference(ref_path)
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
