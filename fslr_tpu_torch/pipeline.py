"""Pipeline orchestrator on an explicit ``torch.device``.

Counterpart of ``fslr_tpu.pipeline``:

  input FASTQ folder -> junk/concatemer filter -> primer ID + trim ->
  ``without_primers.fq`` -> streamed align (seed, extend, select,
  traceback emit, z-drop split) -> ``{name}.bwa_dodi.bam`` + ``.bai``,
  ``{name}.mappings.bed``, ``{name}.filter_counts_summary.csv`` ->
  breakpoint clustering -> ``{name}.mappings.cluster.bed`` and
  ``{name}.mappings.representative.bed`` [-> with ``run_consensus``, the
  per-cluster consensus stage] -> ``{name}.timings.json``.

Every stage runs on the device it is given: plain PyTorch on the CPU, the
CUDA kernels on a card.  The seed index loads (or is built on the device)
on a host thread while the filter runs, as the masked reference is
written with ``reference_mask``; a genome above
``index.reference.MAX_UNSHARDED_BASES`` is indexed and aligned in
contig-aligned shards.  BAM records and mapping-table rows of one align
chunk are built on one host thread while the next chunk aligns.  With
``exact_cigars`` (the default) the BAM carries the traceback CIGARs,
encoded column-wise (``io.bam.encode_chunk_items``); without it,
approximate ones.  Artifacts equal ``fslr_tpu``'s for the same config
either way.

Parallel runs (their artifacts equal a plain run's): a device mesh
shards every batched kernel call by rows (``parallel/dispatch.py``);
several processes, joined by ``torch.distributed`` over gloo, each take a
share of the input files, and process 0 merges their parts and clusters;
``procs`` host threads filter and primer-search input files side by side.
"""

from __future__ import annotations

import contextlib
import glob
import heapq
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.encode import revcomp_str
from fslr_tpu_torch.index import reference as refmod
from fslr_tpu_torch.instrument import StageTimer
from fslr_tpu_torch.io import bam as bamio
from fslr_tpu_torch.io.fastq import glob_input_files, read_reads
from fslr_tpu_torch.panel import load_panel
from fslr_tpu_torch.parallel import dispatch
from fslr_tpu_torch.parallel.distributed import initialize_distributed
from fslr_tpu_torch.parallel.mesh import Mesh, canonical
from fslr_tpu_torch.stages import (align as align_stage, cluster,
                                   consensus, filter_junk, find_primers,
                                   mapping_table)


def _load_indexed(path: str, k: int, device: torch.device, timer=None):
    """Reference + seed index, with the ``{ref}.fslr_k{k}.npz`` cache that
    fslr_tpu's pipeline also reads and writes (``counts`` and
    ``positions``, or per shard ``counts_{i}`` and ``positions_{i}`` with
    the shards' contig ranges in ``shard_bounds``).  A missing, stale or
    unreadable cache is rebuilt on ``device``.  ``timer`` gets the
    seconds of ``index_parse``, ``index_cache_read`` or the build and
    ``index_cache_write``."""
    timed = timer.stage if timer else lambda name: contextlib.nullcontext()
    with timed('index_parse'):
        ref = refmod.load_reference(path)
    cache = f'{path}.fslr_k{k}.npz'
    try:
        if os.path.exists(cache) and \
                os.path.getmtime(cache) >= os.path.getmtime(path):
            with timed('index_cache_read'), np.load(cache) as z:
                if 'shard_bounds' not in z:
                    return ref, refmod.SeedIndex(k=k, counts=z['counts'],
                                                 positions=z['positions'])
                shards = [refmod.IndexShard(
                    ref=refmod.sub_reference(ref, int(c0), int(c1)),
                    contig_base=int(c0),
                    sidx=refmod.SeedIndex(k=k, counts=z[f'counts_{si}'],
                                          positions=z[f'positions_{si}']))
                    for si, (c0, c1) in enumerate(z['shard_bounds'])]
                return ref, refmod.SeedIndex(
                    k=k, counts=np.zeros(0, np.int64),
                    positions=np.zeros(0, np.int32), shards=shards)
    except Exception as e:
        # a truncated write or version skew: say so loudly, then rebuild
        print(f'WARNING: seed-index cache {cache} unreadable '
              f'({type(e).__name__}: {e}); rebuilding from {path}',
              file=sys.stderr)
    sidx = refmod.build_seed_index(ref, k, device, timer=timer)
    if sidx.shards:
        arrs = {'shard_bounds': np.array(
            [(sh.contig_base, sh.contig_base + len(sh.ref.names))
             for sh in sidx.shards], np.int64)}
        for si, sh in enumerate(sidx.shards):
            arrs[f'counts_{si}'] = sh.sidx.counts
            arrs[f'positions_{si}'] = sh.sidx.positions
    else:
        arrs = dict(counts=sidx.counts, positions=sidx.positions)
    try:
        # written aside, then renamed: processes that share the reference
        # never read a half-written cache
        tmp = f'{cache}.{os.getpid()}.{threading.get_ident()}.tmp.npz'
        with timed('index_cache_write'):
            np.savez(tmp, **arrs)
            os.replace(tmp, cache)
    except Exception as e:
        print(f'WARNING: could not write seed-index cache {cache} '
              f'({type(e).__name__}: {e}); next run will rebuild',
              file=sys.stderr)
    return ref, sidx


def _start(fn, *args):
    """Run ``fn(*args)`` on a daemon thread; :func:`_result` waits for it."""
    box: dict = {}

    def run():
        try:
            box['result'] = fn(*args)
        except BaseException as e:        # re-raised in the caller's thread
            box['error'] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, box


def _result(job):
    """The return value of a :func:`_start` job, or its exception."""
    thread, box = job
    thread.join()
    if 'error' in box:
        raise box['error']
    return box['result']


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


def _staged_map(stage, name: str, fn, items: list, workers: int) -> list:
    """``[fn(x) for x in items]``, each call timed as stage ``name``; on a
    pool of ``workers`` host threads when that is more than one, timed
    then as one stage (results in input order)."""
    workers = min(max(1, int(workers or 1)), len(items))
    if workers <= 1:
        out = []
        for x in items:
            with stage(name):
                out.append(fn(x))
        return out
    with stage(name), ThreadPoolExecutor(
            workers, thread_name_prefix='procs') as ex:
        return list(ex.map(fn, items))


def _write_counts(path: str, counts: dict):
    with open(path, 'w') as fc:
        fc.write('Filter counts:' + '\n')
        fc.write(','.join(str(k) for k in counts.keys()) + '\n')
        fc.write(','.join(str(v) for v in counts.values()) + '\n')


def run_pipeline(config: PipelineConfig, device: torch.device,
                 mesh: Mesh | None = None):
    """Run filter -> primers -> align -> BAM + mappings.bed -> clustering
    [-> consensus] on ``device``.

    ``mesh`` (``parallel.mesh.Mesh``, its first device ``device``): every
    batched kernel call of the filter, the primer search and the align
    stage runs in row shards over its devices (parallel/dispatch.py); the
    artifacts equal a run without one.

    ``config.n_processes > 1``: this process is rank ``process_id`` of a
    multi-process run (torch.distributed, gloo, at ``coordinator``): it
    runs filter -> primers -> align on its share of the input files
    (``files[process_id::n_processes]``) as ``{name}__p{process_id}``,
    the counters are summed over the processes, and process 0 merges the
    parts into ``{name}.*`` and clusters them.  Beds and counts equal a
    one-process run's, the BAM's records too, as a multiset.

    ``skip_alignment``: clustering (and consensus) read the
    ``{name}.mappings.bed`` and BAM of an earlier run.  ``procs``: input
    files are filtered and primer-searched on that many host threads.
    With ``reference_mask`` the reads are also mapped against the masked
    reference (``{name}_temp_ref.fa``, written on a host thread while the
    filter runs) and both references' candidates are pooled before
    selection."""
    if not isinstance(device, torch.device):
        raise TypeError(f'device must be a torch.device, not {device!r}')
    if mesh is not None and mesh.devices[0] != canonical(device):
        raise ValueError(f'the mesh starts at {mesh.devices[0]}, not at the '
                         f'run device {device}')
    with dispatch.use_mesh(mesh):
        if config.n_processes > 1:
            return _run_pipeline_multiprocess(config, device)
        return _run_pipeline(config, device)


def _read_counts_csv(path: str) -> dict:
    with open(path) as fh:
        lines = [ln.rstrip('\n') for ln in fh]
    return {k: v if k == 'name' else int(v)
            for k, v in zip(lines[1].split(','), lines[2].split(','))}


def _allreduce_counts(counts: dict) -> dict:
    """The counters summed over the processes of the group, keys in
    first-seen order over ranks 0, 1, ... (fslr_tpu's merge order)."""
    local = {k: v for k, v in counts.items() if k != 'name'}
    if not dist.is_initialized():
        return local
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local)
    merged: dict = {}
    for part in gathered:
        for k, v in part.items():
            merged[k] = merged.get(k, 0) + v
    return merged


def _merge_bams_streamed(parts: list[str], out_path: str):
    """N-way streamed merge of coordinate-sorted BAMs (the samtools merge
    role): raw record copies, constant memory."""
    streams = [bamio.stream_raw_records(p) for p in parts]
    names, lengths = streams[0][0], streams[0][1]
    if any(nm != names for nm, _, _ in streams[1:]):
        raise ValueError('per-process BAM headers differ')

    def _items(it):
        for payload, _qname, rid, pos, rend in it:
            yield (rid if rid >= 0 else 1 << 30), pos, rend, rid, payload

    merged = heapq.merge(*(_items(s[2]) for s in streams),
                         key=lambda t: (t[0], t[1]))
    bamio.write_bam_items(out_path, names, lengths,
                          ((rid, pos, rend, payload)
                           for (_, pos, rend, rid, payload) in merged),
                          sort_by_coord=False, write_index=True)


def _run_pipeline_multiprocess(config: PipelineConfig, device: torch.device):
    """One rank of a multi-process run (fslr_tpu.pipeline.
    _run_pipeline_multihost): the stages on this rank's files, the
    counters summed over the ranks, a barrier, then on rank 0 the merge
    of every rank's part and the clustering.  The group is joined after
    the stages, which need no peer: a rank waits for the others only
    where it needs their results."""
    pid, nproc = config.process_id, config.n_processes
    part = f'{config.name}__p{pid}'
    _run_pipeline(config.replace(name=part, n_processes=1, process_id=0,
                                 skip_clustering=True),
                  device, file_shard=(pid, nproc))
    initialize_distributed(config.coordinator, nproc, pid)
    counts = _allreduce_counts(_read_counts_csv(os.path.join(
        config.out, f'{part}.filter_counts_summary.csv')))
    dist.barrier()
    if pid != 0:
        return

    base = os.path.join(config.out, config.name)
    parts = [os.path.join(config.out, f'{config.name}__p{i}')
             for i in range(nproc)]
    # a read lives in one process, so a stable re-sort of the parts'
    # tables reproduces the one-process order
    mapping_table.write_mappings_bed(
        mapping_table.sort_table(mapping_table.concat_tables(
            [cluster.read_mappings(p + '.mappings.bed', engine='c')
             for p in parts])),
        f'{base}.mappings.bed')
    _merge_bams_streamed([p + '.bwa_dodi.bam' for p in parts],
                         f'{base}.bwa_dodi.bam')
    with open(f'{base}.without_primers.fq', 'w') as out:
        for p in parts:
            if os.path.exists(p + '.without_primers.fq'):
                with open(p + '.without_primers.fq') as fh:
                    out.write(fh.read())
    _write_counts(f'{base}.filter_counts_summary.csv',
                  dict(name=config.name, **counts))
    if not config.keep_temp:
        for p in parts:
            for pth in glob.glob(glob.escape(p) + '.*'):
                os.remove(pth)
    if not config.skip_clustering:
        _run_pipeline(config.replace(skip_alignment=True, n_processes=1,
                                     process_id=0), device)


def _synchronize(device: torch.device):
    """Wait for the work queued on ``device`` and on every card of the
    active mesh, whose shards a stage may leave running."""
    mesh = dispatch.active_mesh()
    for d in dict.fromkeys((device, *(mesh.devices if mesh else ()))):
        if d.type == 'cuda':
            torch.cuda.synchronize(d)


def _run_pipeline(config: PipelineConfig, device: torch.device,
                  file_shard: tuple[int, int] | None = None):
    """One process's run; ``file_shard`` (pid, n) keeps the input files
    ``files[pid::n]``.  With FSLR_PROFILE_DIR set, torch.profiler traces
    the whole run into that folder (instrument.StageTimer)."""
    basename = os.path.join(config.out, config.name)
    print('Basename: ', basename, file=sys.stderr)
    timer = StageTimer(device)
    timer.start_profile(device)
    try:
        finished = _run_stages(config, device, file_shard, basename, timer)
    except BaseException:
        timer.stop_profile(config.name, device, failed=True)
        raise
    timer.stop_profile(config.name, device)
    timer.report(f'{basename}.timings.json')
    if finished:
        print('fslr finished', file=sys.stderr)


def _run_stages(config: PipelineConfig, device: torch.device, file_shard,
                basename: str, timer) -> bool:
    """The stages of _run_pipeline; False when clustering found no
    cluster (the run ends there)."""

    @contextlib.contextmanager
    def stage(name):
        # device work lands in its own stage: wait for it before the
        # stage's clock stops; under torch.profiler the stage is a named
        # range (tools/profile_run.py reads it)
        with timer.stage(name), torch.profiler.record_function(name):
            yield
            _synchronize(device)

    panel = load_panel().subset(config.primers)
    os.makedirs(config.out, exist_ok=True)
    ref = sidx = None
    if not config.skip_alignment:
        ref, sidx = _align_stages(config, device, panel, basename, timer,
                                  stage, file_shard)

    if not config.skip_clustering:
        print('Making clusters')
        with stage('read_mappings'):
            bed = cluster.read_mappings(f'{basename}.mappings.bed',
                                        engine='pyarrow')
            chr_lengths = bamio.get_chromosome_lengths(
                f'{basename}.bwa_dodi.bam')
        with stage('clustering'):
            res = cluster.cluster_stage(bed, chr_lengths, config.cluster,
                                        device)
        timer.notes['query_graph'] = res.stats
        if res.no_clusters:
            print('No clusters were found.')
            return False
        with stage('write_cluster_beds'):
            mapping_table.write_mappings_bed(
                res.cluster_bed, f'{basename}.mappings.cluster.bed')
            mapping_table.write_mappings_bed(
                res.representative_bed,
                f'{basename}.mappings.representative.bed')

        if config.run_consensus:
            print('Creating consensus sequences')
            with stage('load_index'):
                if ref is None:
                    ref, sidx = _load_indexed(config.ref,
                                              config.align.seed_k, device,
                                              timer)
                didx = align_stage.device_index(ref, sidx, device,
                                                config.align)
            with stage('consensus'):
                consensus.run_consensus_stage(res.subgraphs, bed, ref, didx,
                                              panel, config, device)
    return True


def _align_stages(config: PipelineConfig, device: torch.device, panel,
                  basename: str, timer, stage, file_shard):
    """filter -> primers -> align -> ``{name}.bwa_dodi.bam`` + ``.bai``,
    ``.mappings.bed``, ``.without_primers.fq`` and
    ``.filter_counts_summary.csv``.  Returns the reference and its seed
    index (host)."""
    filter_counts = {
        'name': config.name, 'total_kept': 0, 'total_dropped': 0,
        'concatemers_dropped': 0, 'junk_seqs_dropped': 0,
        'short_seqs_dropped': 0, 'False_False': 0,
    }
    # the masked reference is written, and the seed index loaded (or
    # built on the device), on host threads while the filter runs
    masked_ref_path = f'{basename}_temp_ref.fa'
    if config.reference_mask:
        mask_job = _start(refmod.write_masked_reference,
                          config.reference_mask, masked_ref_path, config.ref)
    idx_job = _start(_load_indexed, config.ref, config.align.seed_k, device,
                     timer)

    print('Filtering reads: ', config.basecalled, file=sys.stderr)
    fs = glob_input_files(config.basecalled)
    if file_shard is not None:
        pid, nproc = file_shard
        fs = fs[pid::nproc]
        print(f'process {pid}/{nproc}: {len(fs)} input files',
              file=sys.stderr)
    for pth in fs:
        if os.path.getsize(pth) == 0:
            raise ValueError(f"The file '{pth}' is empty.")

    def _filter_one(pth):
        box: dict = {}
        return filter_junk.run_file(pth, panel, config, device,
                                    out_box=box), box

    # each input file gets its own filtered copy (a uuid name), which the
    # primer stage deletes: explicit lists, never a glob of the out folder
    # that other processes share, keep their files out of this one's hands
    handoff: dict[str, object] = {}
    filtered_files: list[str] = []
    filtered = _staged_map(stage, 'filter_junk', _filter_one, fs,
                           config.procs)
    for c, box in filtered:
        if 'path' in box:
            handoff[box['path']] = box['reads']
            filtered_files.append(box['path'])
        _merge_existing(filter_counts, c)

    for pth in filtered_files:
        if os.path.getsize(pth) == 0:
            print(f"WARNING: The file '{pth}' is empty.", file=sys.stderr)
    primed = _staged_map(
        stage, 'find_primers',
        lambda p: find_primers.run_file(p, panel, config, device,
                                        records=handoff.get(p)),
        filtered_files, config.procs)
    for c in primed:
        _merge_all(filter_counts, c)
    print('Filter counts: ', filter_counts, file=sys.stderr)

    with open(f'{basename}.without_primers.fq', 'w') as out:
        for pth in sorted(p.replace('.filtered_junk.fq', '.no_primers.fq')
                          for p in filtered_files):
            with open(pth) as fh:
                out.write(fh.read())
            os.remove(pth)

    with stage('load_index'):
        ref, sidx = _result(idx_job)
        with stage('index_upload'):
            didx = align_stage.device_index(ref, sidx, device, config.align)
    masked = None
    if config.reference_mask:
        _result(mask_job)
        print(f'Mapping against masked reference defined by '
              f'{config.reference_mask}', file=sys.stderr)
        with stage('load_masked_index'):
            mref, msidx = _load_indexed(masked_ref_path, config.align.seed_k,
                                        device)
            masked = (mref, align_stage.device_index(mref, msidx, device,
                                                     config.align))

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
                        masked=masked,
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
        # the masked reference and its index cache go too
        for pth in glob.glob(f'{basename}_temp_ref.fa*') + labelled:
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

    _write_counts(f'{basename}.filter_counts_summary.csv', filter_counts)

    # the align stage's device tensors (every shard's genome and seed
    # index, and the masked reference's) go before the clustering; the
    # consensus stage uploads the main index again
    del didx, masked
    return ref, sidx
