"""Consensus stage: per-cluster consensus -> re-filter -> re-align -> merge.

Counterpart of ``fslr_tpu/stages/consensus.py``, without pandas, with the
same files:

  * ``{out}/cluster/consensus_seq/{name}.cluster{num}.n_reads{n}.fa``: the
    primary sequences of each cluster's member reads (rows with a
    non-empty ``seq``, in bed order), then ``....cons.fa`` with its
    consensus (ops/poa.py), and ``{out}/cluster/{name}.cluster.consensus
    .fa`` with every non-empty consensus as ``cluster:{num}.n_reads:{n}``;
  * ``{name}.cluster.purity.csv``: per cluster its id, size, consensus and
    the share of members carrying each panel primer;
  * the consensus FASTA re-enters the filter, primer and align stages and
    gives ``{name}.bwa_dodi_cons.bam``;
  * clustered reads are deleted from ``{name}.bwa_dodi.bam``, the
    consensus BAM is merged in (``{name}.bwa_dodi_merged.bam``), and
    ``{name}.mappings_merged.bed`` holds the unclustered rows plus the
    consensus reads' rows, sorted by n_alignments (descending), qname,
    qstart.
"""

from __future__ import annotations

import csv
import glob
import heapq
import os

import numpy as np
import torch

from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.encode import revcomp_str
from fslr_tpu_torch.io import bam as bamio
from fslr_tpu_torch.io.fastq import read_fastx
from fslr_tpu_torch.ops import poa
from fslr_tpu_torch.panel import PrimerPanel
from fslr_tpu_torch.stages import (align as align_stage, cluster,
                                   filter_junk, find_primers, mapping_table)


def _read_primer_names(qname: str) -> set[str]:
    """Primer names (orientation stripped) from the read-name contract
    ``{orig}.{s1}_{s2}.{lab1}_{lab2}``."""
    out = set()
    for lab in qname.split('.')[-1].split('_'):
        if lab and lab != 'False':
            out.add(lab[:-1] if lab[-1] in 'FR' else lab)
    return out


def write_purity_csv(subgraphs, cons_seqs, primer_names, path: str):
    """``.cluster.purity.csv`` as pandas ``to_csv(index=False)`` writes
    the JAX package's frame: cluster, n_reads, consensus and one
    ``{primer}_proportion`` float column per panel primer."""
    header = ['cluster', 'n_reads', 'consensus'] + \
        [f'{p}_proportion' for p in primer_names]
    rows = []
    for num, (clust, seq) in enumerate(zip(subgraphs, cons_seqs)):
        members = list(clust)
        row = [str(num), str(len(clust)), seq]
        for p in primer_names:
            n_with = sum(1 for q in members if p in _read_primer_names(q))
            row.append(str((n_with / len(members)) if members else 0.0))
        rows.append(row)
    with open(path, 'w', newline='') as fh:
        w = csv.writer(fh, lineterminator='\n')
        w.writerow(header)
        w.writerows(rows)


def make_consensus_seq(subgraphs, out: str, name: str, bed: dict,
                       config: PipelineConfig, device: torch.device,
                       primer_names: tuple[str, ...] = ()) -> str:
    """Write the per-cluster FASTAs and the consensus FASTA; returns the
    consensus FASTA's path."""
    cons_dir = os.path.join(out, 'cluster', 'consensus_seq')
    os.makedirs(cons_dir, exist_ok=True)
    qn = bed['qname'].tolist()
    seq = bed['seq'].tolist()
    seq_rows: dict = {}              # qname -> its rows with a sequence
    for i, (q, sq) in enumerate(zip(qn, seq)):
        if isinstance(sq, str) and sq:
            seq_rows.setdefault(q, []).append(i)
    clusters = []
    metas = []
    for num, clust in enumerate(subgraphs):
        rows = sorted(i for q in clust for i in seq_rows.get(q, ()))
        n_reads = len(clust)
        fa = os.path.join(cons_dir, f'{name}.cluster{num}.n_reads'
                                    f'{n_reads}.fa')
        with open(fa, 'w') as fh:
            for i in rows:
                fh.write(f'>{qn[i]}\n{seq[i]}\n')
        clusters.append([seq[i] for i in rows])
        metas.append((num, n_reads))

    cons_seqs = poa.consensus_sequences(clusters, config.consensus, device)
    cat_path = os.path.join(out, 'cluster', f'{name}.cluster.consensus.fa')
    with open(cat_path, 'w') as fh:
        for (num, n_reads), cseq in zip(metas, cons_seqs):
            cons_fa = os.path.join(
                cons_dir, f'{name}.cluster{num}.n_reads{n_reads}.cons.fa')
            with open(cons_fa, 'w') as cf:
                cf.write(f'>cluster:{num}.n_reads:{n_reads}\n{cseq}\n')
            if cseq:
                fh.write(f'>cluster:{num}.n_reads:{n_reads}\n{cseq}\n')
    write_purity_csv(subgraphs, cons_seqs, primer_names,
                     os.path.join(out, 'cluster',
                                  f'{name}.cluster.purity.csv'))
    return cat_path


def delete_alignments(input_bam, output_bam, qnames_to_delete):
    """``samtools view`` with a name filter: records streamed as raw
    payload copies, without decoding."""
    names, lengths, records = bamio.stream_raw_records(input_bam)
    bamio.write_bam_items(
        output_bam, names, lengths,
        ((rid, pos, rend, pl) for (pl, qn, rid, pos, rend) in records
         if qn not in qnames_to_delete),
        sort_by_coord=False)


def merge_bam_files(bam1, bam2, out_bam):
    """``samtools merge`` of two coordinate-sorted BAMs: a streamed
    two-way merge of raw payloads, contig ids remapped in place when the
    headers differ."""
    names, lengths, it1 = bamio.stream_raw_records(bam1)
    names2, _l2, it2 = bamio.stream_raw_records(bam2)
    remap = {i: names.index(n) for i, n in enumerate(names2)
             if n in names}
    identity = all(remap.get(i) == i for i in range(len(names2)))
    mono = all(remap.get(i, 1 << 30) <= remap.get(i + 1, 1 << 30)
               for i in range(len(names2) - 1))

    def _remapped():
        for pl, qn, rid, pos, rend in it2:
            if rid >= 0 and not identity:
                nid = remap.get(rid, -1)
                pl = bamio.patch_ref_id(pl, nid)
                rid = nid
            yield rid, pos, rend, pl

    def _key(rid):
        return rid if rid >= 0 else 1 << 30

    def _merged():
        a = ((rid, pos, rend, pl) for (pl, qn, rid, pos, rend) in it1)
        return heapq.merge(a, _remapped(),
                           key=lambda t: (_key(t[0]), t[1]))

    if mono:
        bamio.write_bam_items(out_bam, names, lengths, _merged(),
                              sort_by_coord=False, write_index=True)
    else:
        # a non-monotone contig remap breaks the stream order: sort
        bamio.write_bam_items(
            out_bam, names, lengths,
            list(_merged()), sort_by_coord=True, write_index=True)


def _consensus_records(aln, qnames, seqs):
    """BAM records of the consensus reads' alignments (exact CIGARs when
    the align stage emitted them, approximate ones otherwise)."""
    records = []
    cig_lists = aln.cigar_lists()
    for i in range(len(aln)):
        ridx = int(aln.read_idx[i])
        pri = bool(aln.is_primary[i])
        rev = bool(aln.strand_rev[i])
        rspan = int(aln.rend[i]) - int(aln.rstart[i]) + 1
        core = cig_lists[i] if cig_lists else None
        if core is not None:
            clip = 'S' if pri else 'H'
            cig = []
            if int(aln.qstart_o[i]) > 0:
                cig.append((int(aln.qstart_o[i]), clip))
            cig += core
            tail = int(aln.qlen[i]) - int(aln.qend_o[i])
            if tail > 0:
                cig.append((tail, clip))
        else:
            cig = bamio.approx_cigar(int(aln.qstart_o[i]),
                                     int(aln.qend_o[i]),
                                     int(aln.qlen[i]), rspan,
                                     hard_clips=not pri)
        seq = ''
        if pri:
            seq = seqs[ridx]
            if rev:
                seq = revcomp_str(seq)
        records.append(bamio.BamRecord(
            qname=qnames[ridx], flag=(16 if rev else 0) | (0 if pri
                                                           else 2048),
            ref_id=int(aln.chrom_idx[i]), pos=int(aln.rstart[i]),
            mapq=int(aln.mapq[i]), cigar=cig, seq=seq, qual=None,
            tags={'AS': int(aln.score[i])}))
    return records


def run_consensus_stage(subgraphs, bed: dict, ref, didx,
                        panel: PrimerPanel, config: PipelineConfig,
                        device: torch.device) -> str:
    """The whole stage; ``bed`` is the mappings.bed columns the clustering
    read, ``didx`` the device index of ``ref``.  Returns the merged BAM's
    path."""
    out = config.out
    name = config.name
    basename = os.path.join(out, name)
    cluster_out = os.path.join(out, 'cluster')
    os.makedirs(cluster_out, exist_ok=True)

    cat_path = make_consensus_seq(subgraphs, out, name, bed, config,
                                  device, primer_names=tuple(panel.names))

    # the consensus FASTA re-enters the filter and primer stages
    ccfg = config.replace(out=cluster_out)
    filter_junk.run_file(cat_path, panel, ccfg, device)
    for pth in glob.glob(f'{cluster_out}/*filtered_junk.fq'):
        find_primers.run_file(pth, panel, ccfg, device)

    qnames, seqs = [], []
    for pth in sorted(glob.glob(f'{cluster_out}/*.primers_labelled.fq')):
        for rec in read_fastx(pth):
            qnames.append(rec.name)
            seqs.append(rec.sequence)

    cons_bam = f'{basename}.bwa_dodi_cons.bam'
    aln = align_stage.align_batch(seqs, ref, didx, config,
                                  regions_path=config.regions)
    bamio.write_bam(cons_bam, ref.names, ref.lengths,
                    _consensus_records(aln, qnames, seqs))

    # delete clustered reads from the original BAM, merge the consensus in
    clustered = set()
    for clust in subgraphs:
        clustered.update(clust)
    delete_bam = f'{basename}.bwa_dodi_delete.bam'
    merged_bam = f'{basename}.bwa_dodi_merged.bam'
    delete_alignments(f'{basename}.bwa_dodi.bam', delete_bam, clustered)
    merge_bam_files(delete_bam, cons_bam, merged_bam)

    # merged mapping table: the unclustered reads' rows as mappings.bed
    # has them, plus the consensus reads' rows
    cons = mapping_table.mapping_table(aln, qnames, seqs, ref.names,
                                       config.regions, panel.seqs)
    orig = cluster.read_mappings(f'{basename}.mappings.bed', engine='c')
    keep = np.array([q not in clustered for q in orig['qname'].tolist()],
                    bool)
    merged = {k: np.concatenate([v[keep], cons[k]]) for k, v in orig.items()}
    mapping_table.write_mappings_bed(mapping_table.sort_table(merged),
                                     f'{basename}.mappings_merged.bed')

    if not config.keep_temp:
        for pth in (glob.glob(f'{cluster_out}/{name}.*.primers_labelled.fq')
                    + [delete_bam, cons_bam]):
            if os.path.exists(pth):
                os.remove(pth)
    return merged_bam
