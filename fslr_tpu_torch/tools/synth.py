"""Synthetic fusion-amplicon datasets.

``make_dataset`` is a copy of ``bench.make_dataset`` (the repo's bench
configuration): for the same arguments it writes the same ``ref.fa`` and
``reads/b0.fastq`` bytes.  Two random contigs chrA and chrB (seed 123);
read ``r{i}`` is the 21q1 target, chrA[1.0 M, +800), chrB[600_000 +
(i % n_groups) * span, +1000), chrA[1.2 M, +800) and the reverse
complement of the 17p6 target, so reads of one breakpoint group are
identical and groups are ``span`` apart on chrB.

``make_grch38_layout_dataset`` writes a human-size reference: GRCh38's 24
primary-assembly chromosomes at their lengths (3,088,269,832 bp) of
seeded random bases in 60-column lines, a mask BED over the reads'
segments, and reads of the same structure with chr1 in chrA's place and
chrX in chrB's.

``make_masked_dataset`` writes the masked-reference scenario of the
JAX package's pipeline tests: one 300 kbp contig, a mask BED and a regions
BED inside it, and two FASTQ files of three reads that lie in both.

``make_cluster_scale_data`` gives the clustering stage's input at scale
without a pipeline run (the data of ``bench.run_cluster_scale``): one
interior interval a read, in breakpoint groups.

``step_inputs`` gives the ten arguments of the fused device step
(``parallel/step.py``) for a reference and a list of reads.

    python -m fslr_tpu_torch.tools.synth ROOT N_READS [N_GROUPS]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from fslr_tpu_torch.encode import decode, revcomp_str
from fslr_tpu_torch.panel import load_panel

REF_MB = 2_000_000


def group_span(ref_mb: int, n_groups: int) -> int:
    """Distance on chrB between the breakpoints of consecutive groups."""
    return max(1, min(40_000, (ref_mb - 700_000) // n_groups))


def make_dataset(root: str, n_reads: int = 1000, n_groups: int = 20,
                 ref_mb: int | None = None) -> tuple[str, str]:
    """Write ``{root}/ref.fa`` and ``{root}/reads/b0.fastq``; returns
    (reference path, FASTQ folder)."""
    if ref_mb is None:
        # groups never overlap: span >= 1500 bp vs 1000 bp intervals
        ref_mb = max(REF_MB, 700_000 + n_groups * 1500 + 100_000)
    rng = np.random.default_rng(123)
    chrA = rng.integers(0, 4, ref_mb).astype(np.uint8)
    chrB = rng.integers(0, 4, ref_mb).astype(np.uint8)
    ref_path = os.path.join(root, 'ref.fa')
    with open(ref_path, 'w') as fh:
        fh.write('>chrA\n' + decode(chrA) + '\n>chrB\n' + decode(chrB) + '\n')
    panel = load_panel().subset(['21q1', '17p6'])
    t21 = panel.targets['21q1']
    t17rc = revcomp_str(panel.targets['17p6'])

    def sub(arr, lo, n):
        return decode(arr[lo:lo + n])

    fq_dir = os.path.join(root, 'reads')
    os.makedirs(fq_dir, exist_ok=True)
    path = os.path.join(fq_dir, 'b0.fastq')
    span = group_span(ref_mb, n_groups)
    with open(path, 'w', buffering=1 << 22) as fh:
        for i in range(n_reads):
            bpos = 600_000 + (i % n_groups) * span
            seq = (t21 + sub(chrA, 1_000_000, 800) + sub(chrB, bpos, 1000)
                   + sub(chrA, 1_200_000, 800) + t17rc)
            fh.write(f'@r{i}\n{seq}\n+\n{"I" * len(seq)}\n')
    return ref_path, fq_dir


# GRCh38 primary assembly (chromosomes only), lengths in bp
GRCH38 = (('chr1', 248956422), ('chr2', 242193529), ('chr3', 198295559),
          ('chr4', 190214555), ('chr5', 181538259), ('chr6', 170805979),
          ('chr7', 159345973), ('chr8', 145138636), ('chr9', 138394717),
          ('chr10', 133797422), ('chr11', 135086622), ('chr12', 133275309),
          ('chr13', 114364328), ('chr14', 107043718), ('chr15', 101991189),
          ('chr16', 90338345), ('chr17', 83257441), ('chr18', 80373285),
          ('chr19', 58617616), ('chr20', 64444167), ('chr21', 46709983),
          ('chr22', 50818468), ('chrX', 156040895), ('chrY', 57227415))
GRCH38_MASK = (('chr1', 900_000, 1_300_000), ('chrX', 500_000, 1_500_000))
_ASCII = np.frombuffer(b'ACGT', np.uint8)


def _fasta_lines(codes: np.ndarray, width: int = 60) -> np.ndarray:
    """ASCII bytes of ``codes`` (0-3) in lines of ``width``, each ending
    in a newline."""
    n = len(codes)
    rows = -(-n // width)
    text = np.empty(rows * width, np.uint8)
    text[:n] = _ASCII[codes]
    buf = np.full((rows, width + 1), ord('\n'), np.uint8)
    buf[:, :width] = text.reshape(rows, width)
    out = buf.reshape(-1)
    if n % width:                  # the short last line
        out = np.concatenate([out[:(rows - 1) * (width + 1) + n % width],
                              out[-1:]])
    return out


def make_grch38_layout_dataset(root: str, n_reads: int = 10_000,
                               n_groups: int = 20,
                               lengths=GRCH38) -> tuple[str, str, str]:
    """Write ``{root}/ref.fa`` (contigs ``lengths``, GRCh38's by default,
    seeded random bases, one contig generated at a time; a test passes
    shorter ones that still hold the reads' segments),
    ``{root}/mask.bed`` (GRCH38_MASK) and ``{root}/reads/b0.fastq``: read
    ``r{i}`` is the 21q1 target, chr1[1.0 M, +800), chrX[600_000 +
    (i % n_groups) * span, +1000), chr1[1.2 M, +800) and the reverse
    complement of the 17p6 target, every segment inside the mask.
    Returns (reference path, FASTQ folder, mask path)."""
    rng = np.random.default_rng(38)
    names = [n for n, _ in lengths]
    span = group_span(dict(lengths)['chrX'], n_groups)
    keep = {'chr1': (1_000_000, 1_200_800),
            'chrX': (600_000, 600_000 + n_groups * span + 1000)}
    held = {}
    ref_path = os.path.join(root, 'ref.fa')
    with open(ref_path, 'wb') as fh:
        for name, n in lengths:
            codes = rng.integers(0, 4, n, dtype=np.uint8)
            if name in keep:
                lo, hi = keep[name]
                held[name] = (lo, codes[lo:hi].copy())
            fh.write(f'>{name}\n'.encode())
            fh.write(_fasta_lines(codes))
            del codes
    mask_path = os.path.join(root, 'mask.bed')
    with open(mask_path, 'w') as fh:
        for chrom, lo, hi in GRCH38_MASK:
            if chrom in names:
                fh.write(f'{chrom}\t{lo}\t{hi}\n')
    panel = load_panel().subset(['21q1', '17p6'])
    t21 = panel.targets['21q1']
    t17rc = revcomp_str(panel.targets['17p6'])

    def sub(chrom, pos, n):
        lo, codes = held[chrom]
        return decode(codes[pos - lo:pos - lo + n])

    fq_dir = os.path.join(root, 'reads')
    os.makedirs(fq_dir, exist_ok=True)
    with open(os.path.join(fq_dir, 'b0.fastq'), 'w',
              buffering=1 << 22) as fh:
        for i in range(n_reads):
            seq = (t21 + sub('chr1', 1_000_000, 800)
                   + sub('chrX', 600_000 + (i % n_groups) * span, 1000)
                   + sub('chr1', 1_200_000, 800) + t17rc)
            fh.write(f'@r{i}\n{seq}\n+\n{"I" * len(seq)}\n')
    return ref_path, fq_dir, mask_path


def make_masked_dataset(root: str) -> tuple[str, str, str, str]:
    """Write ``{root}/ref.fa`` (chrA, 300 kbp of seeded random bases),
    ``{root}/mask.bed`` (chrA 100,000-140,000), ``{root}/regions.bed``
    (chrA 110,000-130,000) and ``{root}/reads/b{0,1}.fastq``, three reads
    each of the 21q1 target, chrA[115,000, +1,200) and the reverse
    complement of the 17p6 target.  Returns (reference path, FASTQ
    folder, mask path, regions path)."""
    rng = np.random.default_rng(99)
    chrA = rng.integers(0, 4, size=300_000).astype(np.uint8)
    ref_path = os.path.join(root, 'ref.fa')
    with open(ref_path, 'w') as fh:
        fh.write('>chrA\n' + decode(chrA) + '\n')
    mask_path = os.path.join(root, 'mask.bed')
    with open(mask_path, 'w') as fh:
        fh.write('chrA\t100000\t140000\n')
    regions_path = os.path.join(root, 'regions.bed')
    with open(regions_path, 'w') as fh:
        fh.write('chrA\t110000\t130000\n')
    panel = load_panel().subset(['21q1', '17p6'])
    seq = (panel.targets['21q1'] + decode(chrA[115_000:116_200])
           + revcomp_str(panel.targets['17p6']))
    fq_dir = os.path.join(root, 'reads')
    os.makedirs(fq_dir, exist_ok=True)
    for f in range(2):
        with open(os.path.join(fq_dir, f'b{f}.fastq'), 'w') as fh:
            for i in range(3):
                fh.write(f'@f{f}r{i}\n{seq}\n+\n{"I" * len(seq)}\n')
    return ref_path, fq_dir, mask_path, regions_path


def make_cluster_scale_data(n_reads: int, group: int = 700, seed: int = 7):
    """The interval items that stages/cluster.query_graph takes, sorted by
    start as prepare_data sorts them: ``n_reads // group`` breakpoint
    groups of ``group`` reads 5 kb apart on chromosome 1 (so
    ``group * (n_reads // group)`` reads; read r in group r // group),
    one interior interval a read, its start and end jittered by +-40 bp,
    qlen2 1,000 and 3 alignments.  The qname is the read id r."""
    from fslr_tpu_torch.stages.cluster import IntervalItem
    n_groups = max(1, n_reads // group)
    rng = np.random.default_rng(seed)
    gid = np.repeat(np.arange(n_groups, dtype=np.int64), group)[:n_reads]
    start = 100_000 + gid * 5_000 + rng.integers(-40, 41, len(gid))
    end = start + 1_000 + rng.integers(-40, 41, len(gid))
    data = [IntervalItem(1, int(s), int(e), float(e - s), r, 3, 1_000,
                         int((e - s) // 2 + s), r)
            for r, (s, e) in enumerate(zip(start, end))]
    data.sort(key=lambda it: it.start)
    return data


def _padded(code_lists) -> tuple[np.ndarray, np.ndarray]:
    """(n, 128) uint8 rows padded with 4, and their int32 lengths."""
    rows = np.full((len(code_lists), 128), 4, np.uint8)
    lens = np.zeros(len(code_lists), np.int32)
    for i, c in enumerate(code_lists):
        rows[i, :len(c)] = c
        lens[i] = len(c)
    return rows, lens


def step_inputs(ref, seqs, L: int, device, primers=None):
    """The ten arguments of ``parallel.step.make_device_step``'s step, as
    ``__graft_entry__._example_inputs`` builds them, on ``device``: reads
    ``seqs`` encoded at width ``L``, the panel's (``primers``: names,
    default all) targets and primer sequences each in both orientations,
    the telomere table, the genome codes of ``ref`` (a FASTA path, or a
    uint8 code array taken as one contig) and its seed index (int32
    counts and positions at the aligner's k, built on ``device``).  The
    reference must fit one index shard."""
    import torch

    from fslr_tpu_torch.config import AlignConfig
    from fslr_tpu_torch.encode import batch_encode, encode, revcomp
    from fslr_tpu_torch.index.reference import (Reference,
                                                build_seed_index,
                                                load_reference)
    from fslr_tpu_torch.ops.kmer_stats import telomere_table

    device = torch.device(device)
    if isinstance(ref, str):
        ref = load_reference(ref)
    else:
        codes = np.asarray(ref, np.uint8)
        ref = Reference(names=['chr1'], lengths=np.array([len(codes)]),
                        offsets=np.array([0, len(codes)]), codes=codes)
    sidx = build_seed_index(ref, AlignConfig().seed_k, device)
    if sidx.shards:
        raise ValueError('step_inputs: the reference needs a sharded '
                         'index; the step takes one genome')
    panel = load_panel()
    if primers is not None:
        panel = panel.subset(list(primers))
    ptargets, ptlens = _padded([f(encode(panel.targets[n]))
                                for n in panel.names
                                for f in (np.asarray, revcomp)])
    pseqs, pslens = _padded([f(encode(panel.seqs[n])) for n in panel.names
                             for f in (np.asarray, revcomp)])
    reads, lens = batch_encode(list(seqs), L)
    arrays = (reads, lens, ptargets, ptlens, pseqs, pslens,
              telomere_table(6), ref.codes, sidx.counts.astype(np.int32),
              sidx.positions.astype(np.int32))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


if __name__ == '__main__':
    args = sys.argv[1:]
    print(*make_dataset(args[0], int(args[1]),
                        *(int(a) for a in args[2:3])))
