"""Synthetic fusion-amplicon dataset (the repo's bench configuration).

A copy of ``bench.make_dataset``: for the same arguments it writes the
same ``ref.fa`` and ``reads/b0.fastq`` bytes.  Two random contigs chrA and
chrB (seed 123); read ``r{i}`` is the 21q1 target, chrA[1.0 M, +800),
chrB[600_000 + (i % n_groups) * span, +1000), chrA[1.2 M, +800) and the
reverse complement of the 17p6 target, so reads of one breakpoint group
are identical and groups are ``span`` apart on chrB.

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


if __name__ == '__main__':
    args = sys.argv[1:]
    print(*make_dataset(args[0], int(args[1]),
                        *(int(a) for a in args[2:3])))
