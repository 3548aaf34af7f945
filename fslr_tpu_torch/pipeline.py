"""Pipeline orchestrator on an explicit ``torch.device``.

Counterpart of ``fslr_tpu.pipeline._run_pipeline`` for one process:

  input FASTQ folder -> junk/concatemer filter -> primer ID + trim ->
  ``without_primers.fq`` -> streamed align (seed, extend, select,
  traceback emit, z-drop split) -> ``{name}.bwa_dodi.bam`` + ``.bai``,
  ``{name}.mappings.bed``, ``{name}.filter_counts_summary.csv`` ->
  breakpoint clustering -> ``{name}.mappings.cluster.bed`` and
  ``{name}.mappings.representative.bed`` [-> with ``run_consensus``, the
  per-cluster consensus stage] -> ``{name}.timings.json``.

Every stage runs on the device it is given: plain PyTorch on the CPU, the
CUDA kernels on a card.  The seed index loads on a host thread while the
filter runs; BAM records and mapping-table rows of one align chunk are
built on one host thread while the next chunk aligns.  With
``exact_cigars`` (the default) the BAM carries the traceback CIGARs,
encoded column-wise (``io.bam.encode_chunk_items``); without it,
approximate ones.  Artifacts equal ``fslr_tpu``'s for the same config
either way.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.encode import revcomp_str
from fslr_tpu_torch.index import reference as refmod
from fslr_tpu_torch.instrument import StageTimer
from fslr_tpu_torch.io import bam as bamio
from fslr_tpu_torch.io.fastq import glob_input_files, read_reads
from fslr_tpu_torch.panel import load_panel
from fslr_tpu_torch.stages import (align as align_stage, cluster,
                                   consensus, filter_junk, find_primers,
                                   mapping_table)


def _check_supported(config: PipelineConfig):
    """Raise NotImplementedError, naming the ROADMAP.md item that ports
    it, for every setting outside this package's slice."""
    todo = [
        (config.reference_mask is None, 'reference_mask',
         'the masked reference and the sharded index'),
        (not config.skip_alignment, 'skip_alignment=True',
         'parallel/ over NCCL'),
        (config.n_processes == 1, 'n_processes > 1',
         'parallel/ over NCCL'),
    ]
    for ok, what, item in todo:
        if not ok:
            raise NotImplementedError(
                f'fslr_tpu_torch does not run {what} yet: ROADMAP.md, '
                f'port queue item "{item}"')


def _load_indexed(path: str, k: int):
    """Reference + seed index, with the ``{ref}.fslr_k{k}.npz`` cache that
    fslr_tpu's pipeline also reads and writes."""
    ref = refmod.load_reference(path)
    if len(ref.codes) > refmod.MAX_UNSHARDED_BASES and len(ref.names) > 1:
        raise NotImplementedError(
            f'{path}: {len(ref.codes)} bases need the sharded index: '
            'ROADMAP.md, port queue item "the masked reference and the '
            'sharded index"')
    cache = f'{path}.fslr_k{k}.npz'
    try:
        if os.path.exists(cache) and \
                os.path.getmtime(cache) >= os.path.getmtime(path):
            with np.load(cache) as z:
                if 'counts' in z:
                    return ref, refmod.SeedIndex(k=k, counts=z['counts'],
                                                 positions=z['positions'])
            print(f'WARNING: seed-index cache {cache} holds a sharded '
                  f'index; rebuilding from {path}', file=sys.stderr)
    except Exception as e:
        # a truncated write or version skew: say so loudly, then rebuild
        print(f'WARNING: seed-index cache {cache} unreadable '
              f'({type(e).__name__}: {e}); rebuilding from {path}',
              file=sys.stderr)
    sidx = refmod.build_seed_index(ref, k)
    try:
        np.savez(cache, counts=sidx.counts, positions=sidx.positions)
    except Exception as e:
        print(f'WARNING: could not write seed-index cache {cache} '
              f'({type(e).__name__}: {e}); next run will rebuild',
              file=sys.stderr)
    return ref, sidx


def _merge_existing(dst: dict, src: dict):
    """Filter-stage merge: only pre-initialised keys accumulate."""
    for k, v in src.items():
        if k in dst:
            dst[k] += v


def _merge_all(dst: dict, src: dict):
    """Primer-stage merge: new keys are created."""
    for k, v in src.items():
        dst[k] = dst.get(k, 0) + v


def _encode_chunk(aln, qnames, seqs, fa, off, bam_items):
    """BAM records of one align chunk with approximate CIGARs (the
    per-record path of fslr_tpu's pipeline: clips + one M run + the
    reference-span indel)."""
    quals = fa.qual_strs(off, off + len(qnames))
    for i in range(len(aln)):
        ridx = int(aln.read_idx[i])
        pri = bool(aln.is_primary[i])
        rev = bool(aln.strand_rev[i])
        cig = bamio.approx_cigar(int(aln.qstart_o[i]), int(aln.qend_o[i]),
                                 int(aln.qlen[i]),
                                 int(aln.rend[i]) - int(aln.rstart[i]) + 1,
                                 hard_clips=not pri)
        seq, qual = '', None
        if pri:
            seq, qual = seqs[ridx], quals[ridx]
            if rev:
                seq = revcomp_str(seq)
                qual = qual[::-1] if qual else None
        bam_items.append(bamio.encode_item(bamio.BamRecord(
            qname=qnames[ridx], flag=(16 if rev else 0) | (0 if pri else 2048),
            ref_id=int(aln.chrom_idx[i]), pos=int(aln.rstart[i]),
            mapq=int(aln.mapq[i]), cigar=cig, seq=seq, qual=qual,
            tags={'AS': int(aln.score[i])})))


def _encode_columnar(aln, fa, off, bam_items):
    """BAM records of one align chunk in one vectorized pass, with the
    exact CIGARs (every row of an exact-CIGAR run has an emit stream)."""
    buf, ofs, plens, rids, poss, rends = bamio.encode_chunk_items(
        aln, off, fa._names, fa.name_off, fa.codes, fa.seq_off, fa._quals,
        fa.qual_off)
    mv = memoryview(buf)
    bam_items.extend(
        (r, p, e, mv[o:o + ln]) for r, p, e, o, ln in zip(
            rids.tolist(), poss.tolist(), rends.tolist(), ofs.tolist(),
            plens.tolist()))


def run_pipeline(config: PipelineConfig, device: torch.device):
    """Run filter -> primers -> align -> BAM + mappings.bed -> clustering
    [-> consensus] on ``device``.

    Takes ``n_processes=1``, no reference_mask, no skip_alignment and an
    unsharded index; anything else raises NotImplementedError.  Input
    files are processed one after another (``procs`` is not used)."""
    if not isinstance(device, torch.device):
        raise TypeError(f'device must be a torch.device, not {device!r}')
    _check_supported(config)
    basename = os.path.join(config.out, config.name)
    print('Basename: ', basename, file=sys.stderr)
    timer = StageTimer()

    @contextlib.contextmanager
    def stage(name):
        # device work lands in its own stage: wait for it before the
        # stage's clock stops; under torch.profiler the stage is a named
        # range (tools/profile_run.py reads it)
        with timer.stage(name), torch.profiler.record_function(name):
            yield
            if device.type == 'cuda':
                torch.cuda.synchronize(device)

    filter_counts = {
        'name': config.name, 'total_kept': 0, 'total_dropped': 0,
        'concatemers_dropped': 0, 'junk_seqs_dropped': 0,
        'short_seqs_dropped': 0, 'False_False': 0,
    }
    panel = load_panel().subset(config.primers)
    os.makedirs(config.out, exist_ok=True)

    # the seed index loads (or builds) on the host while the filter runs
    idx_box: dict = {}

    def _load():
        try:
            idx_box['index'] = _load_indexed(config.ref, config.align.seed_k)
        except BaseException as e:        # re-raised in the main thread
            idx_box['error'] = e

    idx_thread = threading.Thread(target=_load, daemon=True)
    idx_thread.start()

    print('Filtering reads: ', config.basecalled, file=sys.stderr)
    fs = glob_input_files(config.basecalled)
    for pth in fs:
        if os.path.getsize(pth) == 0:
            raise ValueError(f"The file '{pth}' is empty.")
    handoff: dict[str, object] = {}
    filtered_files: list[str] = []
    for pth in fs:
        with stage('filter_junk'):
            box: dict = {}
            c = filter_junk.run_file(pth, panel, config, device, out_box=box)
        if 'path' in box:
            handoff[box['path']] = box['reads']
            filtered_files.append(box['path'])
        _merge_existing(filter_counts, c)

    no_primer_files: list[str] = []
    for pth in filtered_files:
        if os.path.getsize(pth) == 0:
            print(f"WARNING: The file '{pth}' is empty.", file=sys.stderr)
    for pth in filtered_files:
        with stage('find_primers'):
            c = find_primers.run_file(pth, panel, config, device,
                                      records=handoff.get(pth))
        no_primer_files.append(
            pth.replace('.filtered_junk.fq', '.no_primers.fq'))
        _merge_all(filter_counts, c)
    print('Filter counts: ', filter_counts, file=sys.stderr)

    with open(f'{basename}.without_primers.fq', 'w') as out:
        for pth in sorted(no_primer_files):
            with open(pth) as fh:
                out.write(fh.read())
            os.remove(pth)

    with stage('load_index'):
        idx_thread.join()
        if 'error' in idx_box:
            raise idx_box['error']
        ref, sidx = idx_box['index']
        didx = align_stage.device_index(ref, sidx, device, config.align)

    # streamed align: chunk k's BAM records and table rows are built on
    # one host thread while chunk k+1 aligns
    labelled = sorted(
        pth.replace('.filtered_junk.fq', '.primers_labelled.fq')
        for pth in filtered_files)
    CH = config.batch.align_stream_reads
    bam_items: list = []
    tables: list = []

    def _post_chunk(aln, qnames, seqs, fa, off):
        t0 = time.perf_counter()
        items: list = []
        if not config.exact_cigars:
            _encode_chunk(aln, qnames, seqs, fa, off, items)
        elif len(aln):
            _encode_columnar(aln, fa, off, items)
        t1 = time.perf_counter()
        table = mapping_table.mapping_table(
            aln, qnames, seqs, ref.names, config.regions, panel.seqs)
        return items, table, t1 - t0, time.perf_counter() - t1

    def _drain(fut):
        items, table, t_rec, t_map = fut.result()
        bam_items.extend(items)
        tables.append(table)
        # worker time (overlapped with align) under the stage names
        for name, dt in (('bam_records', t_rec), ('mapping_table', t_map)):
            timer.timings[name] = timer.timings.get(name, 0.0) + dt
            timer.counts[name] = timer.counts.get(name, 0) + 1

    pending: list = []
    with ThreadPoolExecutor(1) as post_pool:
        for pth in labelled:
            with stage('read_labelled'):
                fa = read_reads(pth)
            for off in range(0, fa.n, CH):
                hi = min(off + CH, fa.n)
                with stage('read_labelled'):
                    qnames = fa.name_strs(off, hi)
                    seqs = fa.seq_strs(off, hi)
                with stage('align'):
                    aln = align_stage.align_batch(
                        seqs, ref, didx, config, regions_path=config.regions,
                        codes=fa.codes_slice(off, hi), timer=timer)
                pending.append(post_pool.submit(
                    _post_chunk, aln, qnames, seqs, fa, off))
                while len(pending) > 2:
                    _drain(pending.pop(0))
        while pending:
            _drain(pending.pop(0))

    with stage('bam_write'):
        bamio.write_bam_items(f'{basename}.bwa_dodi.bam', ref.names,
                              ref.lengths, bam_items, write_index=True)
    del bam_items
    if not config.keep_temp:
        for pth in labelled:
            os.remove(pth)

    with stage('mapping_table'):
        if len(tables) == 1:
            table = tables[0]
        elif tables:
            # a read lives in one chunk, so a stable re-sort of the
            # concatenation reproduces the unchunked order
            table = mapping_table.sort_table(
                mapping_table.concat_tables(tables))
        else:
            table = mapping_table.mapping_table(
                align_stage.empty_alignments(), [], [], ref.names,
                config.regions, panel.seqs)
        mapping_table.write_mappings_bed(table, f'{basename}.mappings.bed')

    with open(f'{basename}.filter_counts_summary.csv', 'w') as fc:
        fc.write('Filter counts:' + '\n')
        fc.write(','.join(str(k) for k in filter_counts.keys()) + '\n')
        fc.write(','.join(str(v) for v in filter_counts.values()) + '\n')

    # the align stage's device tensors (genome, seed index) go before the
    # clustering; the consensus stage uploads the index again
    del didx

    if not config.skip_clustering:
        print('Making clusters')
        with stage('read_mappings'):
            bed = cluster.read_mappings(f'{basename}.mappings.bed')
            chr_lengths = bamio.get_chromosome_lengths(
                f'{basename}.bwa_dodi.bam')
        with stage('clustering'):
            res = cluster.cluster_stage(bed, chr_lengths, config.cluster,
                                        device)
        if res.no_clusters:
            print('No clusters were found.')
            timer.report(f'{basename}.timings.json')
            return
        with stage('write_cluster_beds'):
            mapping_table.write_mappings_bed(
                res.cluster_bed, f'{basename}.mappings.cluster.bed')
            mapping_table.write_mappings_bed(
                res.representative_bed,
                f'{basename}.mappings.representative.bed')

        if config.run_consensus:
            print('Creating consensus sequences')
            with stage('load_index'):
                didx = align_stage.device_index(ref, sidx, device,
                                                config.align)
            with stage('consensus'):
                consensus.run_consensus_stage(res.subgraphs, bed, ref, didx,
                                              panel, config, device)

    timer.report(f'{basename}.timings.json')
    print('fslr finished', file=sys.stderr)
