"""Primer panel loading.

The shipped panel ``data/primers.csv`` carries the same assay data as the
reference package (primer_name, primer_seq, primer_alignment_target columns;
reference fslr/primers.csv:1-7).  The 20-23 bp ``primer_seq`` is used by the
concatemer scan (fslr/filter_junk_from_fq.py:64-107) and the 68 bp
``primer_alignment_target`` by primer identification + trimming
(fslr/main.py:69-71, fslr/find_reads_with_primers.py:48-75).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Mapping, Sequence

from fslr_tpu_torch.encode import revcomp_str

_DEFAULT_PANEL = os.path.join(os.path.dirname(__file__), 'data', 'primers.csv')


@dataclasses.dataclass(frozen=True)
class PrimerPanel:
    names: tuple[str, ...]
    seqs: Mapping[str, str]          # primer_name -> primer_seq
    targets: Mapping[str, str]       # primer_name -> primer_alignment_target

    @property
    def seqs_rc(self) -> dict[str, str]:
        return {k: revcomp_str(v) for k, v in self.seqs.items()}

    def subset(self, names: Sequence[str]) -> 'PrimerPanel':
        missing = [n for n in names if n not in self.seqs]
        if missing:
            # parity: reference raises ValueError for unknown primer names
            # (fslr/main.py:65-67)
            raise ValueError('Input primer name not in primers.csv',
                             missing[0], set(self.names))
        names = tuple(names)
        return PrimerPanel(
            names=names,
            seqs={n: self.seqs[n] for n in names},
            targets={n: self.targets[n] for n in names},
        )


def load_panel(path: str | None = None) -> PrimerPanel:
    path = path or _DEFAULT_PANEL
    names, seqs, targets = [], {}, {}
    with open(path, newline='') as fh:
        for row in csv.DictReader(fh):
            name = row['primer_name'].strip()
            names.append(name)
            seqs[name] = row['primer_seq'].strip()
            targets[name] = row['primer_alignment_target'].strip()
    return PrimerPanel(names=tuple(names), seqs=seqs, targets=targets)
