#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fslr_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is then not 0):

1. preflight: a CUDA card must be present; prints nvidia-smi's name and
   power limit;
2. build: nvcc compiles fslr_tpu_torch/csrc/*.cu for sm_90a, and g++ the
   port's FASTX parser, fslr_tpu_torch/csrc/fastx.cpp (io/native.py); it
   prints the parser library's path and build seconds, and fails if the
   library lies outside fslr_tpu_torch/_build/;
3. kernel checks: every kernel against its plain PyTorch version on the
   card, at the main path's shapes, from seeded inputs -- the DP kernels
   (banded and tb in both their thread layouts, the SW kernels and prof
   also on their edge cases, sw_kernel also at T = 3072 on rows shaped
   like the fused step's concatemer grid) and the traceback walk (also on
   its edge cases) must match exactly (tb and profile codes in the words that
   hold a row's query steps; the kernels zero the rest), the
   repeat mask may differ in at most 1 decision in 10^6 and only where
   the plain posterior lies within 1e-4 of the threshold; both times are
   printed, with each kernel's bound (the least time the card could take
   for the same work), and the device memory one call of the mask,
   banded and tb kernels allocates (the mask's at most 64 MB);
4. slice: ``fslr_tpu_torch.cli.main`` (exact CIGARs, the default,
   ``--skip-clustering``) on 10,000 synthetic 2.7 kb fusion amplicons
   against a 2 x 50 Mbp random reference (fslr_tpu_torch.tools.synth),
   its seed index built on the card (cold); its six kernels must be
   launched, the artifacts must exist, the planted chrB segment must be
   found in >= 99% of the reads, every primary's CIGAR must span its
   sequence (M + I + S) and a seeded sample of 1,000 records must have an
   AS tag equal to the score replayed from its CIGAR against the
   reference.  Then the earlier path, run_pipeline with
   exact_cigars=False, on the same data (index cache warm): its four
   kernels must be launched, the traceback kernels not, and recall must
   hold.  Then the CLI again on slice-10k's reads as gzip files of two
   members with text after them (tools.synth.gzip_folder; index cache
   warm): the six kernels launched and every artifact, BAM included,
   byte-equal to the cold run; it prints filter_junk's seconds beside the
   cold run's.  Then (phase fastx) the stages' reader, the port's FASTX
   parser, on slice-10k's FASTQ and on a gzip copy of it in two members:
   every field (codes, lowercase mask, names, qualities, comments and
   their offsets) must equal the plain Python parser's; it prints both
   times; then on the FASTQ gzipped in tools.synth.gzip_forms' five forms
   that zlib's gzread reads (text after the member, two members then
   XYZ, the gzip's first half, its trailer cut by 6 bytes, zeros after
   it): the inflated bytes must be the FASTQ or, for the cut member, a
   prefix of it, every field equal to the plain parser's on that text,
   and a flipped CRC byte must raise;
5. index: the port's device build of that reference must equal this
   script's numpy build (``numpy_index``), unsharded and in 2 shards, and
   align_batch on the 10,000 reads must give the same alignments of 50 bp
   or more (every column and CIGAR) with either index (the short anchors
   that the random genome shares with the primer targets depend on which
   of a k-mer's occurrences seeding samples, and a shard holds half of
   them; fslr_tpu's align_batch does the same, tests/
   test_torch_align_ops.py::test_shards_move_short_anchors_as_in_fslr_tpu);
6. consensus: the CLI's default run (clustering) with ``--consensus`` on
   the repo's consensus configuration, 10,000 reads in 500 breakpoint
   groups of 20 on the default 2 x 2 Mbp reference; all seven kernels
   must be launched; every planted group outside the subtelomere mask
   (500 kb from a chromosome end) must be one cluster of its 20 reads,
   the masked groups' reads singletons; each such cluster's consensus
   must equal its members' sequence, and the merged bed and BAM exist.
   Then the same with ``--consensus-engine pileup``: tb_kernel and
   walk_kernel launched inside the consensus stage, prof_kernel nowhere,
   the same cluster checks, cluster and representative beds byte-equal to
   the poa run's, and each of the stage's own tb and walk launches held
   exactly to its plain version on up to 256 seeded rows of it;
7. cross-check: 200 reads on the default 2 x 2 Mbp reference run on the
   card and on the CPU, with exact CIGARs (through the CLI) and without,
   with ``--reference-mask`` over chrA's planted segments, and 200 reads
   in 10 groups with clustering and --consensus, with either engine
   (the CPU halves run in two background processes from the start of
   phase 4, beside phases 4-6, on datasets of the same bytes); every
   artifact (beds, FASTAs, purity CSV, filter
   counts) must be byte-equal and the BAMs' records equal; the JAX
   package's masked scenario (two input files,
   ``--reference-mask`` and ``--regions``) must give byte-equal beds
   and filter counts, BAM records equal as a multiset in coordinate
   order, and records selected from the masked reference; align_batch
   with a 2-shard index must give the same alignments on the card and
   on the CPU as with the unsharded index;
8. human-3g: 10,000 reads against a GRCh38-size reference (GRCh38's 24
   chromosome lengths, 3.09 Gbp of seeded random bases, 4 index shards)
   with ``--reference-mask``, cold (the card builds the sharded index,
   its cache is written) and warm (the cache is read): the slice's six
   kernels must be launched, the planted chrX segment found in >= 99% of
   the reads, alignments of 50 bp or more only on chr1 and chrX, the
   AS replays and spans must hold (the dataset is made in a background
   process from the start of phase 10), no temporary reference may be left,
   and the warm run's artifacts must equal the cold run's.  It prints
   ``load_index`` split into parse, device build per shard, cache write
   or read and upload, each shard's device bytes and peak device memory,
   and times load_reference's bulk FASTA parse against a parse record by
   record (read_fastx + encode), which must give the same codes;
9. cluster-1m (run right after phase 3, before the later phases hold
   device memory): the scale path of breakpoint clustering
   (ops/encounters.py, capwalk.resolve_device) through query_graph and
   get_subgraphs on the card, on tools/synth's cluster-scale data
   (999,600 reads in 1,428 groups of 700, one interior interval a read,
   ~7.0e8 encounters); it must run in-HBM, give 1,428 clusters, and the
   edges of 5 groups spread over the pair keys must equal, in order, the
   host path's on each group alone.  It prints a JSON line with the wall
   time, reads/s, each part's seconds, the encounter, pair, entry and
   edge counts and the peak device memory.  Then (a) the sharded path
   (pk-range and query-range buckets on the card) on the same data, with
   more than one query bucket, must give the in-HBM graph (match rows,
   edges in order, node order), with the same JSON line; (b) 99,400
   reads through the in-HBM, sharded and spill paths must agree; (c)
   19,600 reads on the card and on the CPU, in-HBM and sharded (above
   device_enum_min_encounters); (d) get_subgraphs on (b)'s graph under
   the mesh (cuda, cuda) must equal it without a mesh; (e) 100 frames of
   tools/cap_sweep on the card and on the CPU must give equal records.

10. parallel (run before human-3g): (a) slice-10k's data through
    run_pipeline on a mesh of two entries on the card (``dp_call`` cuts
    every kernel call of the filter, the primer search and the align
    stage into two row shards): the six kernels must be launched and
    every artifact, BAM included, byte-equal to phase 4's cold run (and
    to a one-device run beside it); (b) consensus-10k's reads as four
    input files, with clustering and --consensus, in one process and as
    two CLI processes on the card (``--n-processes 2``, torch.distributed
    over gloo): all seven kernels launched across the processes, beds,
    FASTAs, purity CSV and filter counts byte-equal, BAM records equal as
    a multiset; (c) the same files with ``--procs 4`` equal ``--procs 1``.
    It prints a JSON line with each run's wall time and reads/s and the
    card's name and power limit.

11. step (run before human-3g): the fused device step
    (``parallel.step.make_device_step``) on slice-10k's 10,000 reads as
    one batch at L = 3072 with the whole 6-primer panel
    (``tools.synth.step_inputs``): mask_kernel, sw_kernel, tb_kernel and
    walk_kernel must each be launched, no other kernel; on a seeded
    subset of 512 reads its outputs must equal the plain PyTorch
    versions' on the card exactly (a junk flag may differ only on a read
    where a mask decision differs under phase 3's rule); the step on the
    mesh (cuda:0, cuda:0) (``make_sharded_step``) must equal the single
    step on all 10,000 reads, counters included.  It prints a JSON line
    with the wall time (one warm-up call, then the median of 3), reads/s,
    the peak device memory, the launches per kernel, one call's device
    time by kernel under torch.profiler and the card's name and power
    limit.

12. cards, only with ``--cards N`` (N >= 2, default 4; it raises on a
    host with fewer cards and runs phases 2 and 12 alone): the
    multi-card path on cards 0 .. N-1.  (a) Every kernel on every card
    against its plain version there, by phase 3's rules (timed on the
    first card only); (b) slice-10k through the CLI's default mesh
    (``--mesh-devices 0``): every artifact, BAM and index included,
    byte-equal to one card's cold and warm runs, each slice kernel
    launched on every card; (e) the fused step over the N cards equal
    to one card's, timed in turns (1, N, N, 1); (c) consensus-10k with
    clustering and --consensus on the N cards: every artifact byte-equal
    to one card's, every kernel (prof_kernel included) launched on
    every card; (f) consensus-10k as four files in one process a card
    (``--device cuda:i --mesh-devices 1``) and with the CLI's default
    there (``--mesh-devices 0``: each process meshes every card from its
    own), each equal to one process, every card launching kernels, then
    get_subgraphs on the N-card mesh at 99,400 reads equal to the plain
    call, in turns; (d) human-3g cold on one card and cold on the N
    cards (each card holds the whole index): recall >= 0.99, every
    artifact byte-equal, and the index's bytes replicated to each other
    card timed alone.  Each part prints a JSON line with its walls,
    reads/s and each card's peak device memory.  Phase 12 alone, on a
    list of cards (one card named several times rehearses it on one):

    python3 -c "import tempfile, torch, chip_smoke as c;
    c.build_kernels(); c.run_cards([torch.device('cuda', 0)] * 4,
    tempfile.mkdtemp())"

13. bench (run last): ``python -m fslr_tpu_torch.bench`` as a user runs
    it, in a subprocess: ``--consensus --reads 2000``, then ``--scale
    20000`` (28 groups) in this process, launch counts set to 0 before
    it, then the default mode (1,000 reads, best of 3 warm runs, then
    10,000) against its CPU baseline (``--cpu-baseline`` at 1,000 reads,
    measured anew with 2 torch threads in the background from the end of
    phase 7, the cache removed first; the first two runs need none, so
    they run while it may still run): every JSON line must carry bench.py's keys and name the
    card (nvidia-smi's name and power limit), every slice kernel must be
    launched, every read kept and aligned, and each group outside the
    subtelomere mask one cluster of exactly its reads.  It prints each
    line and a JSON line with each run's seconds; its ``vs_baseline``
    is against the contended baseline (``cpu_baseline_beside_phases``
    names the phases it ran beside), no figure of the bench's own.  When
    the phase ends, pass or fail, the bench's baseline cache
    (fslr_tpu_torch/_build/bench_baseline.json) holds what it held
    before the baseline started, or is absent again.

``--scale N`` (one-off, not run by default; phases 2 and 13's scale run
alone): the default pipeline at N reads in max(20, N // 700) groups
through ``fslr_tpu_torch.bench.run_scale``, held to the planted truth as
in phase 13, and each read's mappings.bed rows to those of a 10,000-read
run of the same template; it prints the peak device memory and host RSS,
the stages at whose end the peak device memory rose, the launches by
kernel, each kernel's device time on its own launches (CUDA events around
each wrapper call, read after the run) and the clustering path and
sizes (query_graph's ``stats``) and the FASTX parser library the run
loaded, after the host's total and available memory before the run:

    python3 chip_smoke.py --scale 1000000

The line before the last is a JSON object with each kernel's launches on
the consensus run (``launches``), on its pileup run
(``launches_pileup``), on human-3g's cold run
(``launches_human_3g``), on the mesh run (``launches_mesh``), summed
over the two processes (``launches_two_processes``), in the fused
step (``launches_step``) and on phase 13's scale run
(``launches_bench_scale_20k``), error, times and bound (with ``--cards``: the
launches of (c), and by card those of (c), (b), (e), (f)'s processes and
(d)); the last line is {"ok": true, "device": {...}}.

Not run by default: ``sweep_layouts`` times both layouts of the banded
and tb kernels on every launch of the slice and consensus runs,

    python3 -c "import torch, chip_smoke; chip_smoke.build_kernels();
    chip_smoke.sweep_layouts(torch.device('cuda'))"

``cluster_paths`` times query_graph through the in-HBM, sharded and
spill paths (or those named) at another read count, with each one's peak
device memory, and checks that their edges agree:

    python3 -c "import torch, chip_smoke as c;
    c.cluster_paths(torch.device('cuda'), 2_000_000)"

``own_launches`` times every kernel on those runs' own launches and saves
the inputs of the SW, tb and prof launches, on which ``time_launches``
times the SW, prof and walk kernels again with whichever package is first
on ``sys.path`` (a parent tree's, in turns; the walk on the codes that
tree's own tb and prof kernels make); the inputs go to a git-ignored path
inside the checkout:

    python3 -c "import torch, chip_smoke; chip_smoke.build_kernels();
    chip_smoke.own_launches(torch.device('cuda'), '_proof/own.pt');
    chip_smoke.time_launches('_proof/own.pt', torch.device('cuda'))"
"""

import argparse
import contextlib
import csv
import dataclasses
import gzip
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from fslr_tpu_torch import kernels
from fslr_tpu_torch.config import (JunkFilterConfig, PipelineConfig,
                                   ScoringConfig)
from fslr_tpu_torch.io import native
from fslr_tpu_torch.ops import (banded, poa, profile_align, ssw, tantan,
                                traceback)
from fslr_tpu_torch.tools.synth import (group_span, gzip_folder, gzip_forms,
                                        make_dataset)

SLICE_READS = 10_000
SLICE_REF_BP = 50_000_000           # per contig, 2 contigs
CONS_READS, CONS_GROUPS = 10_000, 500     # the consensus configuration
CONS_REF_BP = 2_000_000                   # its default reference
SUBTELOMERE = 500_000
CROSS_READS = 200
CROSS_GROUPS = 10
# cluster-1m: tools/synth's cluster-scale data, groups of 700 (999,600
# reads in 1,428 groups), then the spill and card-vs-CPU checks
CLUSTER_READS, CLUSTER_GROUP, VERIFY_GROUPS = 1_000_000, 700, 5
SPILL_READS, CROSS_CLUSTER_READS = 100_000, 20_000
SWEEP_CASES = 100       # tools/cap_sweep frames, on the card and the CPU
AS_SAMPLE = 1_000
CLIPS_ONLY_MAX = 0.02   # share of records with no M/I/D (500 of 44,500 in phase 4)
INDEX_SPLIT_BASES = 60_000_000      # slice-10k's reference in 2 shards
CROSS_SPLIT_BASES = 3_000_000       # the cross-check's reference in 2 shards
CROSS_MASK = 'chrA\t900000\t1300000\n'   # over chrA's planted segments
HUMAN_READS, HUMAN_GROUPS, HUMAN_SHARDS = 10_000, 20, 4
MASK_CALL_BYTES = 64 << 20   # mask_kernel's device memory for one call
# phase 13: the bench's modes (python -m fslr_tpu_torch.bench)
BENCH_CONS_READS, BENCH_SCALE_READS = 2000, 20_000
BENCH_READS_10K = 10_000    # the 10k run of a --scale N check (its rows)
# torch threads of the CPU baseline, which runs beside phases 10, 11 and 8
# and phase 13's runs that need no baseline, leaving them the host's other
# cores
BASELINE_THREADS = 2
BASELINE_BESIDE = ('parallel', 'step', 'human-3g', 'bench --consensus',
                   'bench --scale')
# the fields of a FastxArrays, in the order the parse check prints them
FASTX_FIELDS = ('codes', 'lower', 'seq_off', '_names', 'name_off', '_quals',
                'qual_off', '_comments', 'comment_off')
# bench.py's keys of each mode's JSON line; the port adds 'device'
BENCH_KEYS = {
    'default': {'metric', 'value', 'unit', 'vs_baseline',
                'wall_s_min_med_max', 'wall_s_runs', 'stage_s',
                'stage_s_runs', 'align_dp_cells_per_s', 'dp_cells_per_s',
                'stage_cells_per_s', 'reads_per_s_10k',
                'wall_s_min_med_max_10k', 'wall_s_runs_10k', 'stage_s_10k',
                'stage_s_runs_10k', 'align_dp_cells_per_s_10k',
                'stage_cells_per_s_10k'},
    'consensus': {'metric', 'value', 'unit', 'wall_s', 'wall_s_min_med_max',
                  'stage_s', 'profile_cells', 'profile_cells_per_s',
                  'stage_cells_per_s'},
    'scale': {'metric', 'value', 'unit', 'wall_s', 'stage_s', 'dp_cells',
              'stage_cells_per_s'},
    'cluster-scale': {'metric', 'value', 'unit', 'wall_s', 'n_edges',
                      'n_clusters', 'peak_rss_gb', 'verified_groups'},
}

KERNELS = {   # name -> (source, TPU kernel it replaces)
    'mask_kernel': ('fslr_tpu_torch/csrc/tantan.cu',
                    'fslr_tpu/ops/tantan.py:152'),
    'sw_packed_kernel': ('fslr_tpu_torch/csrc/ssw.cu',
                         'fslr_tpu/ops/ssw.py:428'),
    'sw_kernel': ('fslr_tpu_torch/csrc/ssw.cu', 'fslr_tpu/ops/ssw.py:158'),
    'banded_kernel': ('fslr_tpu_torch/csrc/banded.cu',
                      'fslr_tpu/ops/banded.py:67'),
    'tb_kernel': ('fslr_tpu_torch/csrc/banded.cu',
                  'fslr_tpu/ops/traceback.py:64'),
    # the JAX walk is a lax.scan, not a Pallas kernel
    'walk_kernel': ('fslr_tpu_torch/csrc/traceback.cu',
                    'fslr_tpu/ops/traceback.py:246'),
    'prof_kernel': ('fslr_tpu_torch/csrc/profile.cu',
                    'fslr_tpu/ops/profile_align.py:86'),
}
SLICE_PATH = ('mask_kernel', 'sw_packed_kernel', 'sw_kernel',
              'banded_kernel', 'tb_kernel', 'walk_kernel')
EARLIER_PATH = SLICE_PATH[:4]
# the fused device step (phase 11): one batch of slice-10k's reads
STEP_PATH = ('mask_kernel', 'sw_kernel', 'tb_kernel', 'walk_kernel')
STEP_L, STEP_SUBSET, STEP_REPS = 3072, 512, 3

# The least time the card could take: the larger of operations over the
# float32 CUDA-core peak and bytes (inputs read once, outputs written
# once) over the HBM rate (NVIDIA H100 SXM data sheet, at 700 W).  The
# banded and tb kernels run their DP in int32; the data sheet gives no
# int32 rate, so their operations are held to the float32 peak too (the
# same bound as the float kernels they replaced; optimistic for int32).
PEAK_F32 = 67e12
PEAK_HBM = 3.35e12
# operations per DP cell (per state and position for the mask, per path
# step for the walk), counted from each kernel's step: the score or its
# extraction, E, H, the lazy-F prefix max (in-thread max plus the shuffle
# scan's share), F, the best update, and the traceback code where there
# is one.  The SW kernels' int32 step: H - fg, E, Hno, x, the
# in-thread prefix, its max with the lanes before, H, the column best and
# half a three-way max for the lane best (8.5; the scores come from a
# shared-memory profile); a cell is a (target step, query column) pair that
# the row's lengths need.
OPS_PER_CELL = {'sw_kernel': 8.5, 'sw_packed_kernel': 8.5, 'banded_kernel': 23,
                'tb_kernel': 34, 'prof_kernel': 33, 'mask_kernel': 28,
                'walk_kernel': 20}


def preflight() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: chip_smoke.py needs an NVIDIA '
                           'card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    return smi


def build_kernels() -> float:
    t0 = time.perf_counter()
    kernels.library()
    dt = time.perf_counter() - t0
    print(f'build: {dt:.2f} s ({kernels.library_path()})')
    build_parser()
    return dt


def build_parser() -> float:
    """Builds (unless built) and loads the port's FASTX parser
    (io/native.py: g++ on csrc/fastx.cpp); its library must lie in
    fslr_tpu_torch/_build/ beside this script."""
    t0 = time.perf_counter()
    native.library()
    dt = time.perf_counter() - t0
    path = native.loaded_path()
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'fslr_tpu_torch', '_build')
    if os.path.dirname(os.path.realpath(path)) != os.path.realpath(build_dir):
        raise AssertionError(f'FASTX parser {path} lies outside {build_dir}')
    print(f'build: FASTX parser {dt:.2f} s ({path})')
    return dt


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up (CUDA
    events around the whole run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _call_bytes(fn) -> int:
    """Device memory one call allocates beyond what is allocated before
    it (outputs and scratch), from the allocator's peak."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


def _mutated_copy(rng, src, sub=0.05, indel=0.02):
    """``src`` with substitutions and single-base indels."""
    r = rng.random(len(src))
    out = np.where(r < sub, rng.integers(0, 4, len(src)), src)
    out = out[r >= indel / 2]                          # deletions
    ins = np.flatnonzero(rng.random(len(out)) < indel / 2)
    return np.insert(out, ins, rng.integers(0, 4, len(ins))).astype(np.uint8)


def _bound(name, cells, nbytes) -> dict:
    ops = OPS_PER_CELL[name] * float(cells)
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, float(nbytes) / PEAK_HBM * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by='operations' if t_ops >= t_bytes else 'bytes',
                ops=ops, bytes=float(nbytes))


def _dp_work(qlens, L, n_steps, in_bytes_per_col, out_bytes):
    """(cells, bytes) of a 128-lane row DP: each row runs ``n_steps(qlen)``
    steps of 128 cells and reads its query and its window up to there."""
    steps = n_steps(qlens.long().clamp(0, L))
    cells = int(steps.sum()) * banded.BW
    win = (steps + banded.BW).clamp(max=L + 2 * banded.BW) * (steps > 0)
    nbytes = int(steps.sum()) + int(win.sum()) * in_bytes_per_col
    return cells, nbytes + 4 * len(qlens) + out_bytes


def _walk_work(packed, T):
    """(cells, bytes) of the walk: one step per emitted op plus the stop,
    one code word read per step; the packed scalars and the 2-bit emits
    written."""
    n = packed.shape[1]
    steps = int(packed[5].long().sum()) + n
    return steps, steps * 4 + n * 12 + n * (24 + T // 4)


def _prof_inputs(rng, N, Lq):
    """Seeded reads against seeded POA profiles built through
    ``_ProfileGraph.update``/``planes``: each profile is a backbone plus
    reads with substitutions (fractional scores) and one with an
    insertion (opened columns).  Row 0 is all pad; row lengths are not
    multiples of 8."""
    q = np.full((N, Lq), 4, np.uint8)
    sp = np.empty((N, Lq + 256), np.int32)
    g = np.empty((N, Lq + 256), np.float32)
    qlens = np.zeros(N, np.int32)
    sc = ScoringConfig(gap_open_is_first_base=False)
    for r in range(N):
        L = Lq - int(rng.integers(1, 200))
        backbone = rng.integers(0, 4, L).astype(np.uint8)
        gph = poa._ProfileGraph(backbone)
        for _ in range(3):
            read = _mutated_copy(rng, backbone, sub=0.05, indel=0.0)
            gph.update(read, 0, 0, [(L, 'M')])
        ins = rng.integers(0, 4, 5).astype(np.uint8)
        gph.update(np.concatenate([backbone[:L // 2], ins,
                                   backbone[L // 2:]]), 0, 0,
                   [(L // 2, 'M'), (5, 'I'), (L - L // 2, 'M')])
        sp[r], g[r] = gph.planes(Lq, float(sc.match), float(sc.mismatch),
                                 float(sc.gap_extend))
        if r == 0:
            continue
        read = _mutated_copy(rng, backbone)[:Lq - 1]
        q[r, :len(read)] = read
        qlens[r] = len(read)
    return q, sp, g, qlens


def _exact(name, got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f'{name}: kernel differs from the plain '
                                 f'version in {bad} values')
        err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
    return err


def _check_codes(name, got, want, qlens) -> float:
    """A traceback DP's (score, qend, lane, bits) against the plain
    version: exact in the ends and in the code words that hold a row's
    steps; the kernel's words after them must be 0."""
    err = _exact(name, got[:3], want[:3])
    live = (torch.arange(got[3].shape[1], device=got[3].device)[None, :]
            < ((qlens.long().clamp(min=0) + 7) // 8)[:, None])
    err = max(err, _exact(f'{name} bits', [got[3][live]], [want[3][live]]))
    if got[3][~live].any():
        raise AssertionError(f'{name}: words past a row end are not 0')
    return err


def sw_edge_inputs(B, T=300, seed=21):
    """(q, t, qlens, tlens) for sw_kernel's edge cases, rows unsorted:
    qlen 0, 1, 68 and 128; tlen 0, -1 and > T; all-mismatch rows and
    rows scoring 0; a query holding one word twice (columns tie at the
    maximum) against a target holding it twice (rows tie); code-4 bases
    in query and target."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, 128)).astype(np.uint8)
    t = rng.integers(0, 4, (B, T)).astype(np.uint8)
    qlens = rng.choice(np.array([0, 1, 68, 128, 67, 30], np.int32), B)
    tlens = rng.integers(0, T + 1, B).astype(np.int32)
    for r in range(B):
        kind = r % 8
        if kind == 0:
            tlens[r] = (0, -1, T + 50)[r // 8 % 3]
        elif kind == 1:                           # every cell mismatches
            q[r] = 0
            t[r] = rng.integers(1, 4, T)
        elif kind == 2:                           # only N: every score 0
            t[r] = 4
        elif kind == 3:                           # tied columns and rows
            x = rng.integers(0, 4, 20).astype(np.uint8)
            q[r, :20] = x
            q[r, 40:60] = x
            qlens[r] = max(int(qlens[r]), 68)
            t[r, 30:50] = x
            t[r, 150:170] = x
        elif kind == 4:                           # code 4 in both
            q[r, rng.integers(0, 128, 10)] = 4
            t[r, rng.integers(0, T, 30)] = 4
            c = q[r, :min(int(qlens[r]), 60)]
            t[r, 70:70 + len(c)] = c
        elif kind == 5:                           # a planted mutated copy
            c = _mutated_copy(rng, q[r, :min(int(qlens[r]), 100)])
            t[r, 5:5 + len(c)] = c
    return q, t, qlens, tlens


def sw_packed_edge_inputs(B, stride, T=400, seed=22):
    """(q, t, tlens) for sw_packed_kernel's edge cases at ``stride``:
    primers of 1 to ``stride`` bases, one holding code 4, planted whole,
    mutated, twice (rows tie) and adjacent; tlen 0, -1 and > T; targets of
    only N."""
    rng = np.random.default_rng(seed + stride)
    codes = [rng.integers(0, 4, n).astype(np.uint8)
             for n in (stride, 1, 21, stride // 2)]
    codes[2][5] = 4
    rows, _, _ = ssw.pack_queries(
        codes + [np.where(c < 4, 3 - c, 4)[::-1] for c in codes], stride)
    q = rows[np.arange(B) % len(rows)]
    t = rng.integers(0, 5, (B, T)).astype(np.uint8)
    tlens = rng.integers(0, T + 1, B).astype(np.int32)
    for r in range(B):
        c = codes[r % len(codes)]
        kind = r % 6
        if kind == 0:
            tlens[r] = (0, -1, T + 50)[r // 6 % 3]
        elif kind == 1:
            t[r, 10:10 + len(c)] = c
            t[r, 200:200 + len(c)] = c
        elif kind == 2:
            c = _mutated_copy(rng, c, sub=0.1)
            t[r, 50:50 + len(c)] = c
        elif kind == 3:
            t[r, 60:60 + len(codes[0])] = codes[0]
            t[r, 60 + len(codes[0]):60 + len(codes[0]) + 21] = codes[2]
        elif kind == 4:
            t[r] = 4
    return q, t, tlens


SW_EDGE_ROWS = (1, 3, 5, 301)
SW_GRID_ROWS = (5, 301, 6144)     # 6,144 = the step's 512 reads x 12 primers


def sw_grid_inputs(B, T=3072, seed=24):
    """(q, t, qlens, tlens) shaped like the fused step's concatemer grid:
    primer-length queries (20-23 bases) against read windows of T codes;
    a third of the rows have tlen 0 (reads shorter than the two end
    trims), a third a short tlen (1-149) and the rest up to T; mutated
    copies of the query are planted in every other row, some past the
    row's length."""
    rng = np.random.default_rng(seed + B)
    q = np.full((B, 128), 4, np.uint8)
    qlens = rng.integers(20, 24, B).astype(np.int32)
    t = rng.integers(0, 4, (B, T)).astype(np.uint8)
    kind = np.arange(B) % 3
    tlens = np.where(kind == 0, 0, np.where(
        kind == 1, rng.integers(1, 150, B),
        rng.integers(150, T + 1, B))).astype(np.int32)
    for r in range(B):
        q[r, :qlens[r]] = rng.integers(0, 4, qlens[r])
        if r % 2:
            c = _mutated_copy(rng, q[r, :qlens[r]])
            p = int(rng.integers(0, T - len(c)))
            t[r, p:p + len(c)] = c
    return q, t, qlens, tlens
PROF_EDGE_ROWS = (1, 3, 5, 33)
PROF_EDGE_WIDTHS = (128, 3072)


def prof_edge_inputs(N, Lq, seed=23):
    """(q, sp, g, qlens) for prof_kernel's edge cases, by row (r % 6): an
    all-pad row (qlen 0); a read as long as the row (qlen = Lq); a
    mutated read with N bases (code 4), qlen not a multiple of 8; a read
    matching two copies of a segment in its profile (band columns tie at
    the maximum); a 5-base read; an unrelated read against a profile with
    unsupported columns.  Profiles come from ``_ProfileGraph`` updates
    (fractional scores, opened columns)."""
    rng = np.random.default_rng(seed + Lq)
    q = np.full((N, Lq), 4, np.uint8)
    sp = np.empty((N, Lq + 256), np.int32)
    g = np.empty((N, Lq + 256), np.float32)
    qlens = np.zeros(N, np.int32)
    for r in range(N):
        kind = r % 6
        L = Lq + int(rng.integers(-20, 40))
        backbone = rng.integers(0, 4, L).astype(np.uint8)
        if kind == 3:
            x = rng.integers(0, 4, 40).astype(np.uint8)
            backbone[10:50] = x
            backbone[60:100] = x
        gph = poa._ProfileGraph(backbone)
        for _ in range(2):
            gph.update(_mutated_copy(rng, backbone, sub=0.05, indel=0.0),
                       0, 0, [(L, 'M')])
        if kind == 3:                 # the two copies score alike
            gph.counts[60:100] = gph.counts[10:50]
            gph.spans[60:100] = gph.spans[10:50]
        if kind == 5:
            gph.counts[rng.random(L) < 0.1] = 0
        sp[r], g[r] = gph.planes(Lq, 2.0, -3.0, 2.0)
        if kind == 0:
            continue
        if kind == 1:
            read = _mutated_copy(rng, backbone, sub=0.03, indel=0.01)
            n = Lq
        elif kind == 3:
            read = np.concatenate([x, rng.integers(0, 4, Lq).astype(np.uint8)])
            n = min(Lq, 67)
        elif kind == 4:
            read, n = backbone[:5], 5
        elif kind == 5:
            read = rng.integers(0, 4, Lq).astype(np.uint8)
            n = Lq - 13
        else:
            read = _mutated_copy(rng, backbone)
            read[rng.integers(0, len(read), 5)] = 4
            n = min(len(read), Lq) - 3
        read = read[:n]
        q[r, :len(read)] = read
        qlens[r] = n
    return q, sp, g, qlens


def walk_edge_inputs(N, Lq=256, seed=29):
    """(bits, score, qend, lane) for walk_kernel's edge cases, from codes
    drawn at random (mostly diagonal sources, gaps that mostly extend,
    rare stops), by row (r % 6): a score-0 row (qend 0, lane 0, a stop
    code); an all-diagonal path from the last step down to i = 0 (a
    diagonal run far longer than 8, stopping at i = 0); an I run from lane
    127 that crosses word rows, clamped at lane 127; a D-heavy path from
    lane 2, clamped at lane 0; two random paths."""
    rng = np.random.default_rng(seed + N)
    table = np.array([0] * 1 + [1] * 69 + [2 | 4] * 8 + [2] * 2 + [3 | 8] * 8
                     + [3] * 2 + [1 | 4 | 8] * 10, np.uint8)
    codes = table[rng.integers(0, len(table), (N, Lq, 128), dtype=np.uint8)
                  % len(table)]
    qend = rng.integers(0, Lq, N).astype(np.int32)
    lane = rng.integers(0, 128, N).astype(np.int32)
    score = rng.integers(1, 500, N).astype(np.float32)
    for r in range(N):
        kind = r % 6
        if kind == 0:
            qend[r], lane[r], score[r] = 0, 0, 0.0
            codes[r, 0, 0] = 0
        elif kind == 1:
            qend[r] = Lq - 1
            codes[r, :, lane[r]] = 1
        elif kind == 2:
            lane[r] = 127
            codes[r, :, 127] = 2 | 4
        elif kind == 3:
            lane[r] = 2
            codes[r, :, :3] = 3 | 8
            codes[r, ::7, 0] = 3
    c = codes.reshape(N, Lq // 8, 8, 128).astype(np.uint32)
    bits = np.zeros((N, Lq // 8, 128), np.uint32)
    for k in range(8):
        bits |= c[:, :, k] << (4 * k)
    return bits.view(np.int32), score, qend, lane


def check_prof_walk_edges(dev) -> int:
    """prof_kernel on its edge cases at both widths and walk_kernel on its
    own (1, 5 and 4,097 rows), exact.  Returns the launches checked."""
    kw = profile_align._scores(ScoringConfig(gap_open_is_first_base=False))
    checked = 0
    for Lq in PROF_EDGE_WIDTHS:
        for N in PROF_EDGE_ROWS:
            args = [torch.from_numpy(a).to(dev)
                    for a in prof_edge_inputs(N, Lq)]
            got = profile_align._prof_cuda(*args, **kw)
            want = profile_align._prof_torch(*args, **kw)
            _check_codes(f'prof_kernel ({N} rows, Lq {Lq})', got, want,
                         args[3])
            checked += 1
    for N, Lq in ((1, 256), (5, 256), (4097, 64)):
        bits, score, qend, lane = [torch.from_numpy(a).to(dev)
                                   for a in walk_edge_inputs(N, Lq)]
        _exact(f'walk_kernel ({N} rows)',
               traceback._walk_cuda(bits, score, qend, lane),
               traceback._pack_walk(score, qend, lane, *traceback._walk_torch(
                   bits, qend, lane, Lq + banded.BW)))
        checked += 1
    return checked


def check_sw_edges(dev) -> int:
    """Both SW kernels on their edge cases, at row counts that are not
    multiples of a warp's rows, with both scorings, and sw_kernel at
    T = 3072 on rows shaped like the fused step's concatemer grid: exact.
    Returns the number of launches checked."""
    checked = 0
    for sc in (ScoringConfig(), ScoringConfig(gap_open_is_first_base=False)):
        kw = ssw._scores(sc)
        for B in SW_GRID_ROWS:
            args = [torch.from_numpy(a).to(dev) for a in sw_grid_inputs(B)]
            _exact(f'sw_kernel ({B} rows, T 3072)',
                   ssw._sw_cuda(*args, **kw), ssw._sw_torch(*args, **kw))
            checked += 1
        for B in SW_EDGE_ROWS:
            args = [torch.from_numpy(a).to(dev) for a in sw_edge_inputs(B)]
            _exact(f'sw_kernel ({B} rows)', ssw._sw_cuda(*args, **kw),
                   ssw._sw_torch(*args, **kw))
            for stride in (32, 64, 128):
                args = [torch.from_numpy(a).to(dev)
                        for a in sw_packed_edge_inputs(B, stride)]
                _exact(f'sw_packed_kernel ({B} rows, stride {stride})',
                       ssw._sw_packed_cuda(*args, stride=stride, **kw),
                       ssw._sw_packed_torch(*args, stride=stride, **kw))
            checked += 4
    return checked


def check_kernels(dev, timed: bool = True) -> dict:
    """Each kernel vs its plain version on the card ``dev``; returns
    per-kernel {max_abs_err, ms, plain_ms} (the times None unless
    ``timed``)."""
    def tm(fn, reps):
        return _time_ms(fn, reps) if timed else None

    rng = np.random.default_rng(0)
    sc_ssw = ScoringConfig()
    sc_bwa = ScoringConfig(gap_open_is_first_base=False)
    out = {}

    # sw_kernel: 4096 primer-target rows x 512-base read ends
    B, T = 4096, 512
    q = np.full((B, 128), 4, np.uint8)
    t = rng.integers(0, 4, (B, T)).astype(np.uint8)
    qlens = rng.integers(15, 69, B).astype(np.int32)
    tlens = rng.integers(0, T + 1, B).astype(np.int32)
    for i in range(B):
        q[i, :qlens[i]] = rng.integers(0, 4, qlens[i])
        if i % 2 == 0:
            c = _mutated_copy(rng, q[i, :qlens[i]])
            p = int(rng.integers(0, T - len(c)))
            t[i, p:p + len(c)] = c
    t[rng.random((B, T)) < 0.01] = 4
    q[::97] = 4                                  # rows that score 0
    args = [torch.from_numpy(a).to(dev) for a in (q, t, qlens, tlens)]
    kw = ssw._scores(sc_ssw)
    got = ssw._sw_cuda(*args, **kw)
    want = ssw._sw_torch(*args, **kw)
    n = np.minimum(np.maximum(tlens, 0), T).astype(np.int64)
    out['sw_kernel'] = dict(
        max_abs_err=_exact('sw_kernel', got, want),
        ms=tm(lambda: ssw._sw_cuda(*args, **kw), 10),
        plain_ms=tm(lambda: ssw._sw_torch(*args, **kw), 1),
        edge_cases=check_sw_edges(dev),
        **_bound('sw_kernel', int(n @ np.minimum(qlens, ssw.QP)),
                 B * ssw.QP + int(n.sum()) + 8 * B + 12 * B))

    # sw_packed_kernel: 8192 read windows x 3072 against 4 packed primers
    B, T = 8192, 3072
    prim = [rng.integers(0, 4, 21).astype(np.uint8) for _ in range(2)]
    codes = prim + [3 - p[::-1] for p in prim]
    rows, _, _ = ssw.pack_queries(codes, 32)
    q = rows[np.zeros(B, np.int64)]
    t = rng.integers(0, 4, (B, T)).astype(np.uint8)
    tlens = rng.integers(1, T + 1, B).astype(np.int32)
    for i in range(0, B, 3):
        c = _mutated_copy(rng, codes[i % len(codes)], sub=0.1)
        p = int(rng.integers(0, T - len(c)))
        t[i, p:p + len(c)] = c
    args = [torch.from_numpy(a).to(dev) for a in (q, t, tlens)]
    got = ssw._sw_packed_cuda(*args, stride=32, **kw)
    want = ssw._sw_packed_torch(*args, stride=32, **kw)
    n = np.minimum(np.maximum(tlens, 0), T).astype(np.int64)
    kept = (q < 4).sum(1)        # the primers' columns, not the code-4 pad
    out['sw_packed_kernel'] = dict(
        max_abs_err=_exact('sw_packed_kernel', got, want),
        ms=tm(lambda: ssw._sw_packed_cuda(*args, stride=32, **kw), 3),
        plain_ms=tm(
            lambda: ssw._sw_packed_torch(*args, stride=32, **kw), 1),
        **_bound('sw_packed_kernel', int(n @ kept),
                 B * ssw.QP + int(n.sum()) + 4 * B + 12 * B))

    # banded_kernel: 4096 candidates x 3072-base read slices
    N, Lq = 4096, 3072
    q = rng.integers(0, 4, (N, Lq)).astype(np.uint8)
    w = rng.integers(0, 4, (N, Lq + 256)).astype(np.uint8)
    qlens = rng.integers(1, Lq + 1, N).astype(np.int32)
    for r in range(0, N, 2):
        c = _mutated_copy(rng, q[r, :1500])
        w[r, 64:64 + len(c)] = c
    args = [torch.from_numpy(a).to(dev) for a in (q, w, qlens)]
    kw = ssw._scores(sc_bwa)
    want = banded._banded_torch(*args, **kw)
    for cpl in banded.LAYOUTS:      # both layouts, whichever the launch picks
        _exact(f'banded_kernel at {cpl} columns a lane',
               banded._banded_cuda(*args, cpl=cpl, **kw), want)
    got = banded._banded_cuda(*args, **kw)
    out['banded_kernel'] = dict(
        max_abs_err=_exact('banded_kernel', got, want),
        ms=tm(lambda: banded._banded_cuda(*args, **kw), 3),
        layout_ms={c: tm(lambda c=c: banded._banded_cuda(
            *args, cpl=c, **kw), 3) for c in banded.LAYOUTS},
        plain_ms=tm(lambda: banded._banded_torch(*args, **kw), 1),
        call_bytes=_call_bytes(lambda: banded._banded_cuda(*args, **kw)),
        **_bound('banded_kernel', *_dp_work(args[2].cpu(), Lq, lambda n: n,
                                            1, 12 * N)))

    # tb_kernel and walk_kernel: 1024 selected alignments x 3072-base
    # slices (the banded inputs above; row 0 scores nothing)
    N = 1024
    q[0] = 4
    args = [torch.from_numpy(a[:N]).to(dev) for a in (q, w, qlens)]
    want = traceback._tb_torch(*args, **kw)

    def check_tb(got, what):
        return _check_codes(what, got, want, args[2])

    for cpl in traceback.LAYOUTS:
        check_tb(traceback._tb_cuda(*args, cpl=cpl, **kw),
                 f'tb_kernel at {cpl} columns a lane')
    got = traceback._tb_cuda(*args, **kw)
    out['tb_kernel'] = dict(
        max_abs_err=check_tb(got, 'tb_kernel'),
        ms=tm(lambda: traceback._tb_cuda(*args, **kw), 3),
        layout_ms={c: tm(lambda c=c: traceback._tb_cuda(
            *args, cpl=c, **kw), 3) for c in traceback.LAYOUTS},
        plain_ms=tm(lambda: traceback._tb_torch(*args, **kw), 1),
        call_bytes=_call_bytes(lambda: traceback._tb_cuda(*args, **kw)),
        **_bound('tb_kernel', *_dp_work(
            args[2].cpu(), Lq, lambda n: ((n + 7) // 8 * 8).clamp(max=Lq),
            1, 12 * N + N * Lq * 64)))
    score, qend, lane, bits = got
    T = Lq + banded.BW

    def walk_plain():
        return traceback._pack_walk(score, qend, lane, *traceback._walk_torch(
            want[3], qend, lane, T))

    walked = traceback._walk_cuda(bits, score, qend, lane)
    out['walk_kernel'] = dict(
        max_abs_err=_exact('walk_kernel', walked, walk_plain()),
        ms=tm(lambda: traceback._walk_cuda(bits, score, qend, lane), 3),
        plain_ms=tm(walk_plain, 1),
        **_bound('walk_kernel', *_walk_work(walked[0].cpu(), T)))
    del bits, got, want, walked

    # prof_kernel: 512 POA reads x Lq 2688 against their profiles (the
    # consensus configuration's round width), then the walk on its codes
    N, Lq = 512, 2688
    args = [torch.from_numpy(a).to(dev)
            for a in _prof_inputs(rng, N, Lq)]
    kw = profile_align._scores(ScoringConfig(gap_open_is_first_base=False))
    got = profile_align._prof_cuda(*args, **kw)
    want = profile_align._prof_torch(*args, **kw)
    err = _check_codes('prof_kernel', got, want, args[3])
    if float(want[0][0]) != 0.0 or not bool((want[0][1:] > 0).all()):
        raise AssertionError('prof_kernel: unexpected row scores')
    out['prof_kernel'] = dict(
        max_abs_err=err, edge_cases=check_prof_walk_edges(dev),
        ms=tm(lambda: profile_align._prof_cuda(*args, **kw), 3),
        plain_ms=tm(lambda: profile_align._prof_torch(*args, **kw), 1),
        **_bound('prof_kernel', *_dp_work(
            args[3].cpu(), Lq, lambda n: ((n + 7) // 8 * 8).clamp(max=Lq),
            8, 12 * N + N * Lq * 64)))
    score, qend, lane, bits = got
    T = Lq + banded.BW
    walked = traceback._walk_cuda(bits, score, qend, lane)
    plain = traceback._pack_walk(score, qend, lane, *traceback._walk_torch(
        want[3], qend, lane, T))
    out['walk_kernel']['prof_bits'] = dict(
        max_abs_err=_exact('walk_kernel (profile codes)', walked, plain),
        ms=tm(lambda: traceback._walk_cuda(bits, score, qend, lane), 3),
        **_bound('walk_kernel', *_walk_work(walked[0].cpu(), T)))
    del bits, got, want, walked, plain

    # mask_kernel: the filter's batch at L = 3072
    cfg = JunkFilterConfig()
    B, L = 512, 3072
    seq = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for r in range(0, B, 2):
        p = int(rng.integers(1, 80))
        s = int(rng.integers(0, L - 600))
        seq[r, s:s + 600] = np.tile(seq[r, s:s + p], 600 // p + 1)[:600]
    seq[1::7, 1000:1040] = 4
    st = torch.from_numpy(seq).to(dev)
    got = tantan._posterior_cuda(st, cfg)
    want = tantan._posterior_torch(st, cfg)
    thr = cfg.mask_posterior_threshold
    differ = (got >= thr) != (want >= thr)
    n_diff = int(differ.sum())
    if n_diff > B * L // 1_000_000:
        raise AssertionError(f'mask_kernel: {n_diff} decisions differ')
    if n_diff and float((want[differ] - thr).abs().max()) > 1e-4:
        raise AssertionError('mask_kernel: a differing decision lies more '
                             'than 1e-4 from the threshold')
    mem = _call_bytes(lambda: tantan._posterior_cuda(st, cfg))
    if mem > MASK_CALL_BYTES:
        raise AssertionError(f'mask_kernel: one call allocates {mem} bytes')
    out['mask_kernel'] = dict(
        max_abs_err=float((got - want).abs().max()),
        decisions_differing=n_diff, masked=int((want >= thr).sum()),
        ms=tm(lambda: tantan._posterior_cuda(st, cfg), 3),
        plain_ms=tm(lambda: tantan._posterior_torch(st, cfg), 1),
        call_bytes=mem,
        **_bound('mask_kernel', B * L * (cfg.mask_max_period + 1),
                 B * L * 5))
    for name, r in out.items():
        print(f'kernel {name}: ' + ', '.join(f'{k}={v}'
                                             for k, v in r.items()))
    return out


def _run(root, ref, fq, tag, dev, exact, consensus=False, mask=None,
         regions=None, engine=None):
    """One run on ``dev`` alone: through the CLI with exact CIGARs (its
    default; clustering and consensus with ``consensus``, else
    --skip-clustering; with ``mask``, --reference-mask; with ``regions``,
    --regions; with ``engine``, --consensus-engine; --mesh-devices 1,
    since the CLI's default meshes every card of a host with several),
    through run_pipeline without."""
    out = os.path.join(root, f'out_{tag}')
    if exact:
        from fslr_tpu_torch.cli import main
        main(['--name', 'S', '--out', out, '--ref', ref, '--primers',
              '21q1,17p6', '--basecalled', fq, '--device', str(dev),
              '--mesh-devices', '1']
             + (['--consensus'] if consensus else ['--skip-clustering'])
             + (['--reference-mask', mask] if mask else [])
             + (['--regions', regions] if regions else [])
             + (['--consensus-engine', engine] if engine else []))
    else:
        from fslr_tpu_torch.pipeline import run_pipeline
        run_pipeline(PipelineConfig(name='S', out=out, ref=ref,
                                    primers=('21q1', '17p6'), basecalled=fq,
                                    skip_clustering=True, exact_cigars=False),
                     dev)
    return os.path.join(out, 'S')


def _read_bed(path):
    with open(path, newline='') as fh:
        return list(csv.DictReader(fh, delimiter='\t'))


def _recall(rows, chrom, span, n_reads) -> float:
    """Share of the ``n_reads`` reads whose planted segment is in
    mappings.bed: read r{i} carries chrom[600_000 + (i % 20) * span ...]."""
    found = set()
    for r in rows:
        i = int(r['qname'].split('.')[0][1:])
        bpos = 600_000 + (i % 20) * span
        if r['chrom'] == chrom and abs(int(r['rstart']) - 1 - bpos) <= 50:
            found.add(i)
    return len(found) / n_reads


def _replay(cigar, qcodes, rcodes, pos, sc) -> int:
    """Score of a record's path, replayed from its CIGAR (the kernel's
    scoring: +match / mismatch, N = mismatch, a gap of n costs
    open + n * extend)."""
    qi, ri, score = 0, pos, 0
    for n, op in cigar:
        if op in 'SH':
            qi += n
        elif op == 'M':
            a = qcodes[qi:qi + n]
            b = rcodes[ri:ri + n]
            b = np.concatenate([b, np.full(n - len(b), 4, np.uint8)])
            m = int(np.sum((a == b) & (a < 4) & (b < 4)))
            score += m * sc.match + (n - m) * sc.mismatch
            qi += n
            ri += n
        else:
            score -= abs(sc.gap_open) + abs(sc.gap_extend) * n
            qi += n if op == 'I' else 0
            ri += n if op == 'D' else 0
    return score


def check_bam(base, ref_path, mask=None) -> dict:
    """Every primary's CIGAR spans its sequence; sampled AS tags equal
    their CIGAR replays against the reference, or, for a record from the
    masked reference of a ``mask`` run, against that reference (a masked
    contig holds start - 1 Ns, then ref[start:end], so its coordinates
    lie one base before the reference's).

    A record with clips and no M/I/D is fslr_tpu's own behaviour, kept
    for parity (ROADMAP.md section 3; tests/test_torch_align_exact.py
    plants one): when two band columns tie at the best score, the query
    end and the lane are taken from different columns, the walk starts off
    the best cell and stops at once.  Each such record must have that
    signature (clips spanning the read, AS > 0), they may be at most
    CLIPS_ONLY_MAX of the records, and the sample is drawn from the
    others."""
    from fslr_tpu_torch.encode import encode, revcomp_str
    from fslr_tpu_torch.index.reference import load_reference
    from fslr_tpu_torch.io.bam import read_bam
    _, _, recs = read_bam(base + '.bwa_dodi.bam')
    primary = {}
    for r in recs:
        if r.flag & 2048:
            continue
        qspan = sum(n for n, op in r.cigar if op in 'MIS')
        if qspan != len(r.seq) or not r.seq:
            raise AssertionError(f'{r.qname}: CIGAR spans {qspan} of '
                                 f'{len(r.seq)} bases')
        primary[r.qname] = r
    ref = load_reference(ref_path)
    contigs = [ref.codes[ref.offsets[i]:ref.offsets[i + 1]]
               for i in range(len(ref.names))]
    masked = {}
    for line in open(mask) if mask else ():
        chrom, lo, hi = line.split('\t')[:3]
        ci, lo = ref.names.index(chrom), int(lo)
        masked[ci] = np.concatenate([np.full(max(lo - 1, 0), 4, np.uint8),
                                     contigs[ci][lo:int(hi)]])
    sc = PipelineConfig().align.scoring
    core = [k for k, r in enumerate(recs)
            if any(op in 'MID' for _, op in r.cigar)]
    for k in sorted(set(range(len(recs))) - set(core)):
        r = recs[k]
        clips = sum(n for n, op in r.cigar if op in 'SH')
        if clips != len(primary[r.qname].seq) or r.tags['AS'] <= 0:
            raise AssertionError(
                f'{r.qname} at {r.ref_id}:{r.pos}: CIGAR {r.cigar} with '
                f'AS {r.tags["AS"]} is not a clips-only tie record')
    if len(recs) - len(core) > CLIPS_ONLY_MAX * len(recs):
        raise AssertionError(f'{len(recs) - len(core)} of {len(recs)} '
                             f'records have no M/I/D')
    pick = np.random.default_rng(7).choice(
        core, min(AS_SAMPLE, len(core)), replace=False)
    from_masked = 0
    for k in pick.tolist():
        r = recs[k]
        p = primary[r.qname]
        seq = p.seq if p.is_reverse == r.is_reverse else revcomp_str(p.seq)
        if r.infer_read_length() != len(seq):
            raise AssertionError(f'{r.qname}: CIGAR read length '
                                 f'{r.infer_read_length()} != {len(seq)}')
        got = _replay(r.cigar, encode(seq), contigs[r.ref_id], r.pos, sc)
        if got != r.tags['AS'] and r.ref_id in masked:
            got = _replay(r.cigar, encode(seq), masked[r.ref_id], r.pos, sc)
            from_masked += got == r.tags['AS']
        if got != r.tags['AS']:
            raise AssertionError(f'{r.qname} at {r.ref_id}:{r.pos}: AS '
                                 f'{r.tags["AS"]} != replayed {got}')
    n_indel = sum(any(op in 'ID' for _, op in r.cigar) for r in recs)
    return dict(records=len(recs), primaries=len(primary),
                as_replayed=len(pick), of_them_masked=from_masked,
                no_core_ops=len(recs) - len(core), with_indels=n_indel)


def _run_measured(root, ref, fq, tag, dev, exact, want, consensus=False,
                  mask=None, engine=None):
    """A run with launch counts set to 0 before it and read after it;
    each kernel of ``want`` must have been launched."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    base = _run(root, ref, fq, tag, dev, exact, consensus, mask,
                engine=engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for k in want:
        if launches[k] <= 0:
            raise AssertionError(f'{k} was not launched by the {tag} run')
    with open(base + '.timings.json') as fh:
        stages = json.load(fh)['timings_s']
    return base, wall, launches, torch.cuda.max_memory_allocated(), stages


def run_slice(dev, root):
    """The earlier slices' path at full width: through the CLI (exact
    CIGARs, --skip-clustering), 10k reads, 2 x 50 Mbp reference; then the
    first slice's path (exact_cigars=False) on the same data."""
    t0 = time.perf_counter()
    ref, fq = make_dataset(root, SLICE_READS, 20, ref_mb=SLICE_REF_BP)
    t_data = time.perf_counter() - t0
    for exact in (True, False):
        base, wall, launches, peak, stages = _run_measured(
            root, ref, fq, f'slice_{exact}', dev, exact,
            SLICE_PATH if exact else EARLIER_PATH)
        if not exact and (launches['tb_kernel'] or launches['walk_kernel']):
            raise AssertionError('exact_cigars=False launched a traceback '
                                 'kernel')
        for suffix in ('.bwa_dodi.bam', '.bwa_dodi.bam.bai',
                       '.mappings.bed', '.filter_counts_summary.csv',
                       '.timings.json', '.without_primers.fq'):
            if not os.path.exists(base + suffix):
                raise AssertionError(f'missing artifact {base}{suffix}')
        rows = _read_bed(base + '.mappings.bed')
        recall = _recall(rows, 'chrB', group_span(SLICE_REF_BP, 20),
                         SLICE_READS)
        if recall < 0.99:
            raise AssertionError(f'planted chrB segment found in '
                                 f'{recall:.4f} of reads')
        print(f'slice (exact_cigars={exact}): {SLICE_READS} reads, dataset '
              f'{t_data:.2f} s, pipeline {wall:.2f} s, '
              f'{SLICE_READS / wall:.1f} reads/s, peak device memory '
              f'{peak / 2**30:.3f} GiB, chrB recall {recall:.4f}, bed rows '
              f'{len(rows)}')
        print('slice stages (s): ' + json.dumps(stages))
        print('slice launches: ' + json.dumps(launches))
        if exact:
            t0 = time.perf_counter()
            bam = check_bam(base, ref)
            print(f'slice BAM: {json.dumps(bam)}, '
                  f'checked in {time.perf_counter() - t0:.2f} s')
            cold, cold_stages = base, stages
    run_slice_gzip(dev, root, ref, fq, cold, cold_stages)
    return ref, fq


def run_slice_gzip(dev, root, ref, fq, cold, cold_stages):
    """Slice-10k's reads as a folder of gzip files (tools.synth.gzip_folder:
    two members, then text, which the reader must end the input at)
    through the CLI (exact CIGARs, --skip-clustering, index cache warm):
    the six slice kernels launched and every artifact, BAM and index
    included, byte-equal to the cold run at ``cold``; prints filter_junk's
    seconds (the parse and inflate run inside it) beside the cold run's."""
    gz = gzip_folder(fq, os.path.join(root, 'reads_gz'))
    base, wall, launches, _, stages = _run_measured(
        root, ref, gz, 'slice_gzip', dev, True, SLICE_PATH)
    n = _same_outputs(os.path.dirname(base), os.path.dirname(cold),
                      'gzip input')
    print(f'slice (gzip input, {len(os.listdir(gz))} file(s) of two '
          f'members and text): pipeline {wall:.2f} s, {n} '
          'artifacts, BAM included, byte-equal to the cold run; '
          f'filter_junk {stages["filter_junk"]:.3f} s (plain input, cold '
          f'run: {cold_stages["filter_junk"]:.3f} s); launches '
          + json.dumps(launches))


def _same_field(a, b) -> bool:
    """Equal bytes, or arrays equal in dtype and values."""
    if isinstance(a, bytes):
        return a == b
    return a.dtype == b.dtype and np.array_equal(a, b)


def check_fastx(root, fq_dir, smi) -> dict:
    """The stages' reader (read_reads, the port's FASTX parser) on each
    FASTQ of ``fq_dir`` and on a gzip copy of it in two members, against
    the plain Python parser (records_to_arrays of _read_fastx_py): every
    field equal; then the FASTQ's gzip forms (check_gzip_forms).  Prints
    a JSON line with each parse's seconds."""
    from fslr_tpu_torch.io.fastq import (_read_fastx_py, glob_input_files,
                                         read_reads, records_to_arrays)
    os.makedirs(os.path.join(root, 'fastx'))
    runs = {}
    for path in sorted(glob_input_files(fq_dir)):
        with open(path, 'rb') as fh:
            data = fh.read()
        gz = os.path.join(root, 'fastx', os.path.basename(path) + '.gz')
        with open(gz, 'wb') as fh:
            fh.write(gzip.compress(data[:len(data) // 2], 1))
            fh.write(gzip.compress(data[len(data) // 2:], 1))
        for p in (path, gz):
            t0 = time.perf_counter()
            got = read_reads(p)
            t_native = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = records_to_arrays(_read_fastx_py(p))
            t_plain = time.perf_counter() - t0
            bad = [f for f in FASTX_FIELDS
                   if not _same_field(getattr(got, f), getattr(want, f))]
            if got.n != want.n or bad:
                raise AssertionError(f'{p}: the native parse differs from '
                                     f'the plain one in {bad or "n"}')
            runs[os.path.basename(p)] = dict(
                reads=got.n, bases=int(got.seq_off[-1]),
                file_bytes=os.path.getsize(p), native_s=t_native,
                plain_s=t_plain)
        runs.update(check_gzip_forms(root, path, data, want))
    line = dict(phase='fastx', card=smi.splitlines()[0],
                library=native.loaded_path(), fields=list(FASTX_FIELDS),
                equal=True, runs=runs)
    print(json.dumps(line))
    return line


def check_gzip_forms(root, path, data, plain) -> dict:
    """The FASTQ ``data`` (at ``path``, whose plain parse is ``plain``) in
    tools.synth.gzip_forms' five forms, each through read_reads: the
    bytes it inflates must be ``data`` or, where a member is cut, a prefix
    of it, and every field must equal the plain parser's on the plain text
    those bytes stand for; the form with a flipped CRC byte must raise.
    Returns each form's reads, bases and seconds."""
    from fslr_tpu_torch.io.fastq import (_read_fastx_py, read_reads,
                                         records_to_arrays)
    runs = {}
    stem = os.path.join(root, 'fastx', os.path.basename(path))
    for form, blob in gzip_forms(data).items():
        p = f'{stem}.{form}.gz'
        with open(p, 'wb') as fh:
            fh.write(blob)
        if form == 'bad_crc':
            try:
                read_reads(p)
            except zlib.error as e:
                runs[form] = dict(raised=str(e))
                continue
            raise AssertionError(f'{p}: a failed CRC check did not raise')
        t0 = time.perf_counter()
        got = read_reads(p)
        t_native = time.perf_counter() - t0
        inflated = native.read_bytes(p)
        n = len(inflated)
        if data[:n] != inflated or \
                (n < len(data)) != (form == 'first_half'):
            raise AssertionError(f'{p}: inflated {n} bytes, not the FASTQ '
                                 f'or a cut of it ({len(data)} bytes)')
        want = plain
        if n < len(data):
            cut = f'{stem}.{form}.plain'
            with open(cut, 'wb') as fh:
                fh.write(data[:n])
            want = records_to_arrays(_read_fastx_py(cut))
        bad = [f for f in FASTX_FIELDS
               if not _same_field(getattr(got, f), getattr(want, f))]
        if got.n != want.n or bad:
            raise AssertionError(f'{p}: the native parse differs from the '
                                 f'plain one in {bad or "n"}')
        del inflated
        runs[form] = dict(reads=got.n, bases=int(got.seq_off[-1]),
                          inflated_bytes=n, file_bytes=len(blob),
                          native_s=t_native)
    return runs


def numpy_index(codes, offsets, k):
    """This script's own host build of a seed index, to hold the port's
    device build to: (counts, positions) of every k-mer without an N and
    inside one contig, as one numpy sort of (k-mer << 32 | position)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(4 ** k + 1, np.int64), np.zeros(0, np.int32)
    kmers = np.zeros(n, np.int64)
    valid = np.ones(n, bool)
    for p in range(k):
        c = codes[p:p + n]
        kmers *= 4
        kmers += np.minimum(c, 3)
        valid &= c < 4
    for off in offsets[1:-1].tolist():
        valid[max(0, off - k + 1):off] = False
    pos = np.flatnonzero(valid)
    kmers = kmers[pos]
    counts = np.zeros(4 ** k + 1, np.int64)
    np.cumsum(np.bincount(kmers, minlength=4 ** k), out=counts[1:])
    kmers <<= 32
    kmers |= pos
    kmers.sort()
    return counts, (kmers & 0xffffffff).astype(np.int32)


def _shards(ref, sidx):
    """(reference, index, contig base) of each shard, or of the whole."""
    return ([(sh.ref, sh.sidx, sh.contig_base) for sh in sidx.shards]
            if sidx.shards else [(ref, sidx, 0)])


def _aligned_rows(aln) -> list:
    """Every Alignments column and CIGAR of each row, rows sorted: a
    sharded index gives each shard's alignments in turn."""
    cols = [getattr(aln, f).tolist() for f in (
        'read_idx', 'chrom_idx', 'rstart', 'rend', 'strand_rev', 'qstart_o',
        'qend_o', 'qlen', 'score', 'mapq', 'is_primary', 'overlaps_region')]
    cig = aln.cigar_lists() or [None] * len(aln)
    return sorted(zip(*cols, (tuple(c) if c else () for c in cig)))


def _align_rows(ref, sidx, dev, codes) -> list:
    from fslr_tpu_torch.stages import align as align_stage
    config = PipelineConfig()
    didx = align_stage.device_index(ref, sidx, dev, config.align)
    return _aligned_rows(align_stage.align_batch([], ref, didx, config,
                                                 codes=codes))


def check_index(dev, ref_path, fq):
    """The port's device build of slice-10k's reference (2 x 50 Mbp)
    equals this script's numpy build, unsharded and in 2 shards, and
    align_batch on the slice's 10,000 reads gives the same alignments of
    50 bp or more with either index."""
    from fslr_tpu_torch.index.reference import (MAX_UNSHARDED_BASES,
                                                build_seed_index,
                                                load_reference)
    from fslr_tpu_torch.io.fastq import read_reads
    ref = load_reference(ref_path)
    k = PipelineConfig().align.seed_k
    built = []
    for cap, n_shards in ((MAX_UNSHARDED_BASES, 1), (INDEX_SPLIT_BASES, 2)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sidx = build_seed_index(ref, k, dev, cap)
        t_dev = time.perf_counter() - t0
        parts = _shards(ref, sidx)
        if len(parts) != n_shards:
            raise AssertionError(f'{len(parts)} shards at {cap} bases')
        t0 = time.perf_counter()
        for sref, s, base in parts:
            counts, positions = numpy_index(sref.codes, sref.offsets, k)
            if not (np.array_equal(counts, s.counts)
                    and np.array_equal(positions, s.positions)):
                raise AssertionError(f'device build of the shard from '
                                     f'contig {base} differs from numpy')
        print(f'index: device build == numpy build in {n_shards} shard(s) '
              f'({len(ref.codes)} bases; device {t_dev:.2f} s, numpy '
              f'{time.perf_counter() - t0:.2f} s)')
        built.append(sidx)
    fa = read_reads(os.path.join(fq, 'b0.fastq'))
    codes = fa.codes_slice(0, fa.n)
    rows = [_align_rows(ref, sidx, dev, codes) for sidx in built]
    # seeding samples C = 16 of a k-mer's occurrences; a 50 Mbp shard
    # holds about half a 100 Mbp genome's, so the short anchors that a
    # random genome shares with the primer targets may differ, in
    # fslr_tpu as in the port (tests/test_torch_align_ops.py::
    # test_shards_move_short_anchors_as_in_fslr_tpu)
    long_rows = [[r for r in rs if r[3] - r[2] + 1 >= 50] for rs in rows]
    if long_rows[0] != long_rows[1] or not long_rows[0]:
        raise AssertionError('align_batch with 2 shards differs from the '
                             'unsharded index in alignments of >= 50 bp')
    short = [set(rs) - set(lr) for rs, lr in zip(rows, long_rows)]
    print(f'index: align_batch of {fa.n} reads, 2 shards == unsharded in '
          f'all {len(long_rows[0])} alignments of >= 50 bp (every column '
          f'and CIGAR); shorter: {len(short[0])} unsharded, '
          f'{len(short[1])} sharded, {len(short[0] ^ short[1])} in one '
          'only')


def _read_fasta(path):
    with open(path) as fh:
        lines = fh.read().split()
    return dict(zip((h[1:] for h in lines[0::2]), lines[1::2]))


def check_clusters(base, n_reads, n_groups, ref_bp):
    """Each planted group outside the subtelomere mask (read r{i} is in
    group i % n_groups) is one cluster of exactly its reads
    (planted_clusters), and that cluster's consensus equals the members'
    sequence.  Reads of masked groups stay singletons unless another
    shared interval links them: a spurious short alignment in the primer
    makes the chrA segment a filling, and such reads of several masked
    groups cluster together, as in fslr_tpu.  Returns (planted clusters,
    all clusters)."""
    planted, members = planted_clusters(base, n_reads, n_groups, ref_bp)
    size = n_reads // n_groups
    multi = {cl for cl, reads in members.items() if len(reads) > 1}
    out = os.path.dirname(base)
    name = os.path.basename(base)
    cons = _read_fasta(os.path.join(out, 'cluster',
                                    f'{name}.cluster.consensus.fa'))
    nums = {int(h.split('.')[0].split(':')[1]): (h, seq)
            for h, seq in cons.items()}
    if not set(planted) <= set(nums) or not set(nums) <= multi:
        raise AssertionError(f'{len(cons)} consensus records for '
                             f'{len(planted)} planted clusters')
    for num in planted:
        head, seq = nums[num]
        fa = _read_fasta(os.path.join(
            out, 'cluster', 'consensus_seq',
            f'{name}.cluster{num}.n_reads{size}.fa'))
        if len(fa) != size or set(fa.values()) != {seq}:
            raise AssertionError(f'cluster {num}: consensus differs from '
                                 'its members')
    for suffix in ('.mappings_merged.bed', '.bwa_dodi_merged.bam',
                   '.mappings.representative.bed'):
        if not os.path.exists(base + suffix):
            raise AssertionError(f'missing artifact {base}{suffix}')
    return len(planted), len(multi)


def run_consensus(dev, root) -> tuple:
    """This slice's main path: the CLI's default run (clustering) with
    --consensus on the repo's consensus configuration, then the same with
    ``--consensus-engine pileup`` (run_pileup).  Returns the launch counts
    of each run."""
    root = os.path.join(root, 'consensus')
    os.makedirs(root)
    t0 = time.perf_counter()
    ref, fq = make_dataset(root, CONS_READS, CONS_GROUPS)
    t_data = time.perf_counter() - t0
    base, wall, launches, peak, stages = _run_measured(
        root, ref, fq, 'consensus', dev, True, KERNELS, consensus=True)
    planted, n_clusters = check_clusters(base, CONS_READS, CONS_GROUPS,
                                         CONS_REF_BP)
    print(f'consensus: {CONS_READS} reads in {CONS_GROUPS} groups, dataset '
          f'{t_data:.2f} s, pipeline {wall:.2f} s, '
          f'{CONS_READS / wall:.1f} reads/s, peak device memory '
          f'{peak / 2**30:.3f} GiB, {n_clusters} clusters, of them '
          f'{planted} planted groups outside the subtelomere mask, each of '
          f'{CONS_READS // CONS_GROUPS} reads with consensus == members')
    print('consensus stages (s): ' + json.dumps(stages))
    print('consensus launches: ' + json.dumps(launches))
    return launches, run_pileup(dev, root, ref, fq, base)


PILEUP_KERNELS = ('tb_kernel', 'walk_kernel')   # the pileup's own launches
PILEUP_ROWS = 256   # rows of each such launch held to the plain version


def run_pileup(dev, root, ref, fq, poa_base) -> dict:
    """consensus-10k through the CLI with ``--consensus-engine pileup``:
    the slice kernels launched, prof_kernel not; tb_kernel and
    walk_kernel launched inside the consensus stage (ops/poa.py's
    banded_sw_tb and walk, each member against its backbone window of
    L + 128); each planted group one cluster whose consensus equals its
    members (check_clusters); cluster and representative beds byte-equal
    to the poa run's at ``poa_base``.  The consensus stage's own tb and
    walk launches keep, on the host, their inputs and outputs at up to
    PILEUP_ROWS seeded rows, and after the run each is held exactly to
    its plain version on those rows (tb codes in the words that hold a
    row's query steps, as phase 3).  Returns the run's launch counts."""
    rng = np.random.default_rng(16)
    inside, own, saved = [False], dict.fromkeys(KERNELS, 0), []

    def hook(name, fn, args, kw):
        out = fn(*args, **kw)
        if inside[0]:
            own[name] += 1
            if name in PILEUP_KERNELS:
                n = args[0].shape[0]
                idx = torch.from_numpy(np.sort(rng.choice(
                    n, min(n, PILEUP_ROWS), replace=False))).to(
                        args[0].device)
                if name == 'walk_kernel':   # packed (6, N), emits (N, T/4)
                    rows = (out[0][:, idx], out[1][idx])
                else:
                    rows = tuple(o[idx] for o in out)
                saved.append((name, n, tuple(a[idx].cpu() for a in args),
                              kw, tuple(o.cpu() for o in rows)))
        return out

    stage = poa.consensus_sequences

    def consensus_sequences(*a, **k):
        inside[0] = True
        try:
            return stage(*a, **k)
        finally:
            inside[0] = False
    undo = _wrapped(KERNELS, hook)
    poa.consensus_sequences = consensus_sequences
    try:
        base, wall, launches, peak, stages = _run_measured(
            root, ref, fq, 'consensus_pileup', dev, True, SLICE_PATH,
            consensus=True, engine='pileup')
    finally:
        poa.consensus_sequences = stage
        undo()
    if launches['prof_kernel'] or own['prof_kernel']:
        raise AssertionError('the pileup engine launched prof_kernel')
    for k in PILEUP_KERNELS:
        if own[k] <= 0:
            raise AssertionError(f'{k} was not launched by the pileup '
                                 'consensus stage')
    planted, n_clusters = check_clusters(base, CONS_READS, CONS_GROUPS,
                                         CONS_REF_BP)
    for suffix in ('.mappings.cluster.bed', '.mappings.representative.bed'):
        _same(base + suffix, poa_base + suffix, f'{suffix} (pileup vs poa)')
    checked = []
    for i, (name, n, args, kw, got) in enumerate(saved):
        args = [a.to(dev) for a in args]
        got = [o.to(dev) for o in got]
        what = f'pileup {name} launch {i} ({n} rows)'
        if name == 'tb_kernel':
            want = traceback._tb_torch(*args, **{
                k: v for k, v in kw.items() if k != 'cpl'})
            err = _check_codes(what, got, want, args[2])
        else:
            bits, score, qend, lane = args
            T = bits.shape[1] * 8 + banded.BW
            err = _exact(what, got, traceback._pack_walk(
                score, qend, lane, *traceback._walk_torch(bits, qend, lane,
                                                          T)))
        Lq = args[0].shape[1] * (8 if name == 'walk_kernel' else 1)
        checked.append(dict(kernel=name, rows=n, checked_rows=len(args[0]),
                            Lq=int(Lq), max_abs_err=err))
    print(f'consensus (pileup engine): pipeline {wall:.2f} s, '
          f'{CONS_READS / wall:.1f} reads/s, consensus stage '
          f'{stages["consensus"]:.2f} s, peak device memory '
          f'{peak / 2**30:.3f} GiB, {n_clusters} clusters, of them '
          f'{planted} planted groups each with consensus == members; '
          'cluster and representative beds == the poa run\'s; launches in '
          'the consensus stage ' + json.dumps(own) + ', in the run '
          + json.dumps(launches))
    print('consensus (pileup engine) launches held to the plain versions '
          'on their own rows: ' + json.dumps(checked))
    return launches


def _same(a, b, what):
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
        da, db = fa.read(), fb.read()
    if a.endswith('.bam'):
        da, db = gzip.decompress(da), gzip.decompress(db)
    if da != db:
        raise AssertionError(f'{what}: the two runs differ')


def _bam_parts(path):
    """A BAM's header bytes and its records' bytes, in file order."""
    with open(path, 'rb') as fh:
        data = gzip.decompress(fh.read())
    o = 8 + int.from_bytes(data[4:8], 'little')
    n_ref = int.from_bytes(data[o:o + 4], 'little')
    o += 4
    for _ in range(n_ref):
        o += 8 + int.from_bytes(data[o:o + 4], 'little')
    head, recs = data[:o], []
    while o < len(data):
        n = 4 + int.from_bytes(data[o:o + 4], 'little')
        recs.append(data[o:o + n])
        o += n
    return head, recs


def _masked_regions_same(base, cpu_base, ref, mask):
    """The masked-reference scenario of the JAX package's pipeline tests
    (tools.synth.make_masked_dataset: two input files, --reference-mask,
    --regions), its card run at ``base`` against its CPU run at
    ``cpu_base``.  With regions, each read's alignment to the masked copy
    (one base before the reference's) is selected besides its reference
    one.  mappings.bed and the filter counts byte-equal; the BAM's header
    equal and its records equal as a multiset in the same coordinate
    order (the two files' filtered copies carry random names, which order
    records that tie on coordinates); the masked records' AS replayed on
    the masked layout."""
    for suffix in ('.mappings.bed', '.filter_counts_summary.csv'):
        _same(base + suffix, cpu_base + suffix, f'{suffix} (masked, regions)')
    (head, recs), (head_c, recs_c) = (_bam_parts(b + '.bwa_dodi.bam')
                                      for b in (base, cpu_base))
    if head != head_c or sorted(recs) != sorted(recs_c) or \
            [r[4:12] for r in recs] != [r[4:12] for r in recs_c]:
        raise AssertionError('BAM (masked, regions): the two runs differ')
    bam = check_bam(base, ref, mask)
    if bam['of_them_masked'] == 0:
        raise AssertionError('masked, regions: no record from the masked '
                             'reference')
    print(f'cross-check (--reference-mask and --regions, 2 files): card == '
          f'CPU for mappings.bed, filter_counts_summary.csv and BAM records '
          f'(as a multiset, in coordinate order); BAM {json.dumps(bam)}')


CROSS_CPU_THREADS = 3   # torch threads of each of phase 7's CPU processes
CROSS_ENGINES = ('poa', 'pileup')


def _cross_runs(root, d) -> dict:
    """Phase 7's runs on device ``d`` (the card, or the CPU in a process of
    cross_cpu_beside), each dataset made under ``root``: 200 reads with
    exact CIGARs and without, with --reference-mask over chrA's planted
    segments, the masked scenario with --regions, and the 2-shard
    align_batch (its rows as JSON).  Returns the run bases and rows."""
    from fslr_tpu_torch.index.reference import (build_seed_index,
                                                load_reference)
    from fslr_tpu_torch.io.fastq import read_reads
    from fslr_tpu_torch.tools.synth import make_masked_dataset
    ref, fq = make_dataset(root, CROSS_READS)
    out = {}
    for key, exact in (('exact', True), ('approx', False)):
        out[key] = _run(root, ref, fq, f'{d.type}_{exact}', d, exact)
    out['mask'] = os.path.join(root, 'mask.bed')
    with open(out['mask'], 'w') as fh:
        fh.write(CROSS_MASK)
    out['masked'] = _run(root, ref, fq, f'{d.type}_masked', d, True,
                         mask=out['mask'])
    mroot = os.path.join(root, 'masked_regions')
    os.makedirs(mroot)
    mref, mfq, mmask, regions = make_masked_dataset(mroot)
    out['regions'] = (_run(mroot, mref, mfq, d.type, d, True, mask=mmask,
                           regions=regions), mref, mmask)
    href = load_reference(ref)
    fa = read_reads(os.path.join(fq, 'b0.fastq'))
    out['rows'] = [json.dumps(_align_rows(href, build_seed_index(
        href, PipelineConfig().align.seed_k, d, cap), d,
        fa.codes_slice(0, fa.n)))
        for cap in (CROSS_SPLIT_BASES, 2 * CROSS_SPLIT_BASES)]
    out['n_align'] = fa.n
    return out


def _consensus_runs(root, d) -> dict:
    """Phase 7's 200 reads in 10 groups with clustering and --consensus
    on ``d``, with each engine; returns the run bases by engine."""
    ref, fq = make_dataset(root, CROSS_READS, CROSS_GROUPS)
    return {e: _run(root, ref, fq, f'{d.type}_{e}', d, True, consensus=True,
                    engine=e) for e in CROSS_ENGINES}


def cross_cpu(root, part):
    """Phase 7's CPU halves in a process of their own (cross_cpu_beside):
    ``part`` 'runs' (_cross_runs) or 'consensus' (_consensus_runs) on the
    CPU under ``root``; writes what cross_check reads to
    ``root/runs.json``."""
    fn = _cross_runs if part == 'runs' else _consensus_runs
    with open(os.path.join(root, 'runs.json'), 'w') as fh:
        json.dump(fn(root, torch.device('cpu')), fh)


@contextlib.contextmanager
def cross_cpu_beside(root):
    """Phase 7's CPU halves in the background for the block (from the
    start of phase 4): cross_cpu's two parts, each in a process of
    CROSS_CPU_THREADS torch threads with no card visible and a directory
    of its own under ``root``.  Yields ({part: (process, its root)}, the
    start); the processes are stopped when the block ends."""
    procs = {}
    try:
        for part in ('runs', 'consensus'):
            proot = os.path.join(root, f'cross_cpu_{part}')
            os.makedirs(proot)
            with open(os.path.join(proot, 'err'), 'w') as err:
                procs[part] = (subprocess.Popen(
                    [sys.executable, '-c', 'import chip_smoke; chip_smoke.'
                     f'cross_cpu({proot!r}, {part!r})'],
                    stdout=subprocess.DEVNULL, stderr=err,
                    cwd=os.path.dirname(os.path.abspath(__file__)),
                    env=dict(os.environ,
                             OMP_NUM_THREADS=str(CROSS_CPU_THREADS),
                             CUDA_VISIBLE_DEVICES='')), proot)
        yield procs, time.perf_counter()
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _cross_cpu_done(procs) -> tuple:
    """Waits for cross_cpu_beside's processes; returns ({part: what it
    wrote}, seconds waited)."""
    t0 = time.perf_counter()
    out = {}
    for part, (proc, proot) in procs.items():
        rc = proc.wait(timeout=900)
        if rc:
            with open(os.path.join(proot, 'err')) as fh:
                raise AssertionError(f'phase 7 on the CPU ({part}): rc {rc}'
                                     '\n' + fh.read()[-3000:])
        with open(os.path.join(proot, 'runs.json')) as fh:
            out[part] = json.load(fh)
    return out, time.perf_counter() - t0


def cross_check(dev, root, cpu):
    """200 reads on the card and on the CPU, with and without exact
    CIGARs, with --reference-mask, and with clustering and consensus
    (either engine): artifacts byte-equal; the masked scenario with
    regions (_masked_regions_same); a 2-shard align_batch.  The CPU halves
    ran in the background (``cpu`` from cross_cpu_beside) on datasets of
    the same bytes."""
    procs, t_start = cpu
    root = os.path.join(root, 'cross')
    os.makedirs(root)
    card = _cross_runs(root, dev)
    croot = os.path.join(root, 'consensus')
    os.makedirs(croot)
    card_cons = _consensus_runs(croot, dev)
    t_card = time.perf_counter()
    done, waited = _cross_cpu_done(procs)
    cpu, cpu_cons = done['runs'], done['consensus']
    for key, what in (('exact', 'exact_cigars=True'),
                      ('approx', 'exact_cigars=False'),
                      ('masked', f'--reference-mask, {CROSS_MASK.strip()!r}')):
        base_g = card[key]
        for suffix in ('.mappings.bed', '.filter_counts_summary.csv',
                       '.bwa_dodi.bam'):
            _same(base_g + suffix, cpu[key] + suffix, f'{suffix} ({what})')
        n_rows = len(_read_bed(base_g + '.mappings.bed'))
        print(f'cross-check ({what}): {CROSS_READS} reads, card == CPU for '
              f'mappings.bed ({n_rows} rows), filter_counts_summary.csv and '
              'BAM records')
    _masked_regions_same(card['regions'][0], cpu['regions'][0],
                         *card['regions'][1:])
    if card['rows'][0] != cpu['rows'][0]:
        raise AssertionError('2-shard align_batch: card and CPU differ')
    if card['rows'][0] != card['rows'][1]:
        raise AssertionError('2-shard align_batch differs from unsharded')
    print(f'cross-check (2 shards): align_batch of {card["n_align"]} reads, '
          f'card == CPU == unsharded '
          f'({len(json.loads(card["rows"][0]))} alignments, every column '
          'and CIGAR)')
    for engine, base in card_cons.items():
        n_files = _same_outputs(os.path.dirname(base),
                                os.path.dirname(cpu_cons[engine]),
                                f'cross-check (consensus, {engine})')
        _, n = check_clusters(base, CROSS_READS, CROSS_GROUPS, CONS_REF_BP)
        print(f'cross-check (consensus, {engine} engine): {CROSS_READS} '
              f'reads in {n} clusters, card == CPU for {n_files} artifacts '
              '(beds, FASTAs, purity CSV, BAMs)')
    print(f'cross-check: the CPU halves started {t_card - t_start:.1f} s '
          f'before the card halves ended; waited {waited:.1f} s for them')


PAR_FILES = 4            # consensus-10k's reads as four input files
PAR_GROUP_TIMEOUT_S = 300   # a process waits at most this for its peer
PAR_PROC_TIMEOUT_S = 600    # and is killed after this


def _tree(out) -> dict:
    """relative path -> bytes of every artifact under ``out``, but the
    timings; a BAM as its records sorted (equal as a multiset), the
    reads without primers as their sorted records, and no index, which
    follows the BAM's record order."""
    files = {}
    for dirpath, _, names in os.walk(out):
        for n in names:
            path = os.path.join(dirpath, n)
            rel = os.path.relpath(path, out)
            if n.endswith(('.timings.json', '.bai', '.no_primers.fq')):
                continue
            if n.endswith('.bam'):
                head, recs = _bam_parts(path)
                files[rel] = head + b''.join(sorted(recs))
            elif n.endswith('.without_primers.fq'):
                with open(path, 'rb') as fh:
                    lines = fh.read().split(b'\n')
                files[rel] = b''.join(sorted(
                    b'\n'.join(lines[i:i + 4])
                    for i in range(0, len(lines) - 1, 4)))
            else:
                with open(path, 'rb') as fh:
                    files[rel] = fh.read()
    return files


def _same_trees(a, b, what):
    ta, tb = _tree(a), _tree(b)
    if sorted(ta) != sorted(tb):
        raise AssertionError(f'{what}: the files differ: '
                             f'{sorted(set(ta) ^ set(tb))}')
    for rel in ta:
        if ta[rel] != tb[rel]:
            raise AssertionError(f'{what}: {rel} differs')
    return len(ta)


def _split_reads(fq, n_files):
    """Rewrite the folder's b0.fastq as ``n_files`` files, record i in
    file i % n_files."""
    src = os.path.join(fq, 'b0.fastq')
    with open(src, 'rb') as fh:
        lines = fh.read().split(b'\n')
    recs = [b'\n'.join(lines[i:i + 4]) + b'\n'
            for i in range(0, len(lines) - 1, 4)]
    for f in range(n_files):
        with open(os.path.join(fq, f'part{f}.fastq'), 'wb') as fh:
            fh.write(b''.join(recs[f::n_files]))
    os.remove(src)
    return len(recs)


def _processes(argv, out, root, devices):
    """The CLI in one process a device of ``devices`` (``--n-processes
    len(devices)``, process i with ``--device devices[i]``, gloo at a free
    local port), each with its launch counts set to 0 before it and
    written to a file after it, with its launches by card and each card's
    peak device memory.  Returns (wall seconds, launch counts summed over
    the processes, [{'launches': {kernel: {card: n}}, 'peak_bytes': {card:
    bytes}} a process])."""
    n = len(devices)
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        coord = f'127.0.0.1:{s.getsockname()[1]}'
    code = ('import json, sys, torch\n'
            'from fslr_tpu_torch import cli, kernels\n'
            'from fslr_tpu_torch.parallel import distributed\n'
            f'distributed.TIMEOUT_S = {PAR_GROUP_TIMEOUT_S}\n'
            'kernels.reset_launches()\n'
            'cli.main(sys.argv[2:])\n'
            'with open(sys.argv[1], "w") as fh:\n'
            '    json.dump(dict(launches=kernels.launch_counts(True),\n'
            '                   peak_bytes={i: torch.cuda.max_memory_'
            'allocated(i)\n'
            '                   for i in range(torch.cuda.device_count())}'
            '), fh)\n')
    counts = [os.path.join(root, f'launches_p{pid}.json')
              for pid in range(n)]
    logs = [os.path.join(root, f'log_p{pid}.txt') for pid in range(n)]
    t0 = time.perf_counter()
    procs = []
    try:
        for pid in range(n):
            with open(logs[pid], 'wb') as log:
                procs.append(subprocess.Popen(
                    [sys.executable, '-c', code, counts[pid], *argv, '--out',
                     out, '--device', str(devices[pid]), '--n-processes',
                     str(n), '--process-id', str(pid), '--coordinator',
                     coord],
                    cwd=os.path.dirname(os.path.abspath(__file__)),
                    stdout=log, stderr=subprocess.STDOUT))
        # a failed process ends the run at once: its peers would wait for
        # it until their group's timeout
        deadline = time.monotonic() + PAR_PROC_TIMEOUT_S
        while any(p.poll() is None for p in procs) and \
                not any(p.poll() for p in procs) and \
                time.monotonic() < deadline:
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    # the first process that failed on its own, before those killed here
    failed = sorted((p.returncode < 0, pid) for pid, p in enumerate(procs)
                    if p.returncode)
    if failed:
        pid = failed[0][1]
        with open(logs[pid], 'rb') as fh:
            tail = fh.read()[-3000:].decode(errors='replace')
        raise AssertionError(f'process {pid} of {n} exited with '
                             f'{procs[pid].returncode}:\n{tail}')
    launches = dict.fromkeys(KERNELS, 0)
    per_process = []
    for path in counts:
        with open(path) as fh:
            got = json.load(fh)
        per_process.append(got)
        for k, by_card in got['launches'].items():
            launches[k] += sum(by_card.values())
    return wall, launches, per_process


def _timed(fn, want, what):
    """``fn()`` with launch counts set to 0 before it and read after it;
    each kernel of ``want`` must have been launched.  Returns (wall
    seconds, launch counts)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    missing = [k for k in want if launches[k] <= 0]
    if missing:
        raise AssertionError(f'{what}: {missing} not launched')
    return wall, launches


def run_parallel(dev, root, slice_ref, slice_fq, smi) -> dict:
    """Phase 10: the parallel layer on this card.  (a) slice-10k through
    run_pipeline on a mesh of two entries on this card: every artifact
    byte-equal to phase 4's cold run; (b) consensus-10k's reads as four
    input files, with clustering and --consensus, in one process and in
    two CLI processes on this card: beds, FASTAs and counts byte-equal,
    BAM records equal as a multiset; (c) the same files with --procs 4
    against --procs 1.  Returns the launch counts of the mesh run and of
    the two processes."""
    from fslr_tpu_torch.cli import _parser, config_from_args, main
    from fslr_tpu_torch.parallel.mesh import Mesh
    from fslr_tpu_torch.pipeline import run_pipeline
    runs = []

    def slice_run(tag, mesh):
        out = os.path.join(root, f'out_parallel_{tag}')
        config = config_from_args(_parser().parse_args(
            ['--name', 'S', '--out', out, '--ref', slice_ref, '--primers',
             '21q1,17p6', '--basecalled', slice_fq, '--skip-clustering']))
        wall, launches = _timed(lambda: run_pipeline(config, dev, mesh=mesh),
                                SLICE_PATH, f'slice-10k ({tag})')
        runs.append(dict(run=f'slice-10k, {tag}', reads=SLICE_READS,
                         wall_s=wall, reads_per_s=SLICE_READS / wall))
        return os.path.join(out, 'S'), launches

    mesh = Mesh((dev, dev))
    on = ', '.join(map(str, mesh.devices))
    base_single, _ = slice_run('one device (index cache warm)', None)
    base_mesh, mesh_launches = slice_run(f'mesh ({on})', mesh)
    cold = os.path.join(root, 'out_slice_True', 'S')
    for suffix in ('.mappings.bed', '.filter_counts_summary.csv',
                   '.without_primers.fq', '.bwa_dodi.bam',
                   '.bwa_dodi.bam.bai'):
        for base, what in ((cold, 'phase 4'), (base_single, 'one device')):
            with open(base + suffix, 'rb') as fa, \
                    open(base_mesh + suffix, 'rb') as fb:
                if fa.read() != fb.read():
                    raise AssertionError(f'mesh run: {suffix} differs from '
                                         f'the {what} run')
    print(f'parallel (a): slice-10k on the mesh ({on}): every '
          'artifact, BAM included, byte-equal to phase 4\'s cold run; '
          'launches ' + json.dumps(mesh_launches))

    croot = os.path.join(root, 'parallel_consensus')
    os.makedirs(croot)
    ref, fq = make_dataset(croot, CONS_READS, CONS_GROUPS)
    n = _split_reads(fq, PAR_FILES)
    argv = ['--name', 'C', '--ref', ref, '--primers', '21q1,17p6',
            '--basecalled', fq, '--consensus', '--mesh-devices', '1']
    outs = {}
    for procs in (1, 4):
        outs[procs] = os.path.join(croot, f'out_procs{procs}')
        wall, launches = _timed(
            lambda: main(argv + ['--out', outs[procs], '--procs',
                                 str(procs), '--device', str(dev)]),
            KERNELS, f'consensus-10k, --procs {procs}')
        runs.append(dict(run=f'consensus-10k in {PAR_FILES} files, one '
                         f'process, --procs {procs}', reads=n, wall_s=wall,
                         reads_per_s=n / wall))
    check_clusters(os.path.join(outs[1], 'C'), CONS_READS, CONS_GROUPS,
                   CONS_REF_BP)
    out2 = os.path.join(croot, 'out_two_processes')
    wall, two_launches, _ = _processes(argv, out2, croot, (dev, dev))
    missing = [k for k in KERNELS if two_launches[k] <= 0]
    if missing:
        raise AssertionError(f'two processes: {missing} not launched')
    runs.append(dict(run=f'consensus-10k in {PAR_FILES} files, two '
                     f'processes on {mesh.devices[0]}', reads=n, wall_s=wall,
                     reads_per_s=n / wall))
    n_two = _same_trees(outs[1], out2, 'two processes')
    n_procs = _same_trees(outs[1], outs[4], '--procs 4')
    print(f'parallel (b): two processes == one process ({n_two} artifacts: '
          'beds, FASTAs, purity CSV and counts byte-equal, BAM records as '
          'a multiset); launches summed over the processes '
          + json.dumps(two_launches))
    print(f'parallel (c): --procs 4 == --procs 1 ({n_procs} artifacts)')
    print('parallel runs: ' + json.dumps(dict(card=smi.splitlines()[0],
                                              runs=runs)))
    return dict(mesh=mesh_launches, two_processes=two_launches)


def _plain(fn):
    """``fn()`` with every kernel wrapper taking its plain PyTorch version
    on the card's tensors (``kernels.on_card`` answers False)."""
    on_card = kernels.on_card
    kernels.on_card = lambda x: False
    try:
        return fn()
    finally:
        kernels.on_card = on_card


def _same_step(got, want, what, junk_may_differ=()):
    """Every output of two step runs equal, counters included; a junk
    flag may differ only on the rows ``junk_may_differ`` (and then the
    counters are not compared)."""
    junk = set(torch.nonzero(got['junk'] != want['junk']).flatten()
               .tolist())
    if not junk <= set(junk_may_differ):
        raise AssertionError(f'{what}: junk differs on rows '
                             f'{sorted(junk)[:10]}')
    for key, w in want.items():
        if key not in ('junk', 'counters') and not torch.equal(got[key], w):
            raise AssertionError(f'{what}: {key} differs in '
                                 f'{int((got[key] != w).sum())} values')
    if not junk:
        for k, c in want['counters'].items():
            if int(got['counters'][k]) != int(c):
                raise AssertionError(f'{what}: counter {k} '
                                     f'{int(got["counters"][k])} != {int(c)}')


# CUDA kernel names (as the profiler shows them) of each kernel of the
# step: sw_kernel's C entry also launches its row-order kernel
STEP_KERNEL_NAMES = {'mask_kernel': ('mask_kernel',),
                     'sw_kernel': ('sw_dp', 'order_rows'),
                     'tb_kernel': ('banded_dp',),
                     'walk_kernel': ('walk_kernel',)}


def _profile_step(fn) -> dict:
    """One ``fn()`` under torch.profiler (CPU and CUDA activities): its
    wall ms, the union of its device events (busy ms), the device ms of
    each kernel of the step and of everything else (torch's own kernels,
    copies and sets), and the eight largest other device consumers."""
    from fslr_tpu_torch.tools.profile_run import _union_us
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by = dict.fromkeys([*STEP_KERNEL_NAMES, 'other'], 0.0)
    other: dict = {}
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        group = next((k for k, names in STEP_KERNEL_NAMES.items()
                      if any(n in e.name for n in names)), 'other')
        by[group] += ms
        if group == 'other':
            other[e.name[:80]] = other.get(e.name[:80], 0.0) + ms
    top = sorted(other.items(), key=lambda x: -x[1])[:8]
    busy = _union_us((e.time_range.start, e.time_range.end)
                     for e in events) / 1e3
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                device_busy_share=busy / wall_ms, device_ms=by,
                top_other_device_ms=dict(top))


def run_step(dev, ref_path, fq_dir, smi) -> dict:
    """Phase 11: the fused device step on slice-10k's reads at L = 3072
    (one warm-up call with the launch counts read after it, then the
    median of three), a seeded subset against the plain versions on the
    card, and the mesh (dev, dev) against one device.  Returns the
    warm-up call's launch counts."""
    from fslr_tpu_torch.io.fastq import read_fastx
    from fslr_tpu_torch.parallel.mesh import Mesh
    from fslr_tpu_torch.parallel.step import (make_device_step,
                                              make_sharded_step)
    from fslr_tpu_torch.tools.synth import step_inputs
    t0 = time.perf_counter()
    seqs = [r.sequence for f in sorted(os.listdir(fq_dir))
            for r in read_fastx(os.path.join(fq_dir, f))]
    args = step_inputs(ref_path, seqs, STEP_L, dev)
    torch.cuda.synchronize()
    t_inputs = time.perf_counter() - t0
    n, NP = len(seqs), int(args[2].shape[0])
    config = PipelineConfig()
    n_seed = (STEP_L - config.align.seed_k) // config.align.seed_stride + 1
    step = make_device_step(config, NP, STEP_L, n_seed)
    out = {}
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    warm, launches = _timed(lambda: out.update(step(*args)), STEP_PATH,
                            'the fused step')
    peak = torch.cuda.max_memory_allocated()
    others = [k for k in KERNELS if k not in STEP_PATH and launches[k]]
    if others:
        raise AssertionError(f'the fused step launched {others}')
    counts = {k: int(v) for k, v in out['counters'].items()}
    if counts['total_kept'] + counts['total_dropped'] != n or \
            counts['aligned_segments'] < n:
        raise AssertionError(f'the fused step: counters {counts}')
    walls = []
    for _ in range(STEP_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = step(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    _same_step(again, out, 'the fused step called again')
    del again
    wall = float(np.median(walls))
    profile = _profile_step(lambda: step(*args))

    # a seeded subset: the kernels against the plain versions on the card
    rows = torch.from_numpy(np.sort(np.random.default_rng(11).choice(
        n, STEP_SUBSET, replace=False))).to(dev)
    sub = (args[0][rows].contiguous(), args[1][rows].contiguous(),
           *args[2:])
    got = step(*sub)
    want = _plain(lambda: step(*sub))
    cfg = config.junk
    post_k = tantan._posterior_cuda(sub[0], cfg)
    post_p = tantan._posterior_torch(sub[0], cfg)
    thr = cfg.mask_posterior_threshold
    inside = ((torch.arange(STEP_L, device=dev)[None, :] < sub[1][:, None])
              & (sub[0] != 4))
    differ = ((post_k >= thr) != (post_p >= thr)) & inside
    n_diff = int(differ.sum())
    if n_diff > STEP_SUBSET * STEP_L // 1_000_000 or (n_diff and float(
            (post_p[differ] - thr).abs().max()) > 1e-4):
        raise AssertionError(f'the fused step: {n_diff} mask decisions '
                             'differ beyond phase 3\'s rule')
    _same_step(got, want, f'the fused step on {STEP_SUBSET} reads, card '
               'against plain', torch.nonzero(differ.any(1)).flatten()
               .tolist())
    del got, want, post_k, post_p

    # the mesh of two entries on this card against one device
    mesh = Mesh((dev, dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = make_sharded_step(mesh, config, NP, STEP_L, n_seed)(*args)
    torch.cuda.synchronize()
    mesh_wall = time.perf_counter() - t0
    _same_step(sharded, out, f'the fused step on the mesh {mesh.devices}')
    del sharded, out
    report = dict(
        phase='step', card=smi.splitlines()[0], reads=n, L=STEP_L,
        primer_rows=NP, inputs_s=t_inputs, warmup_s=warm, walls_s=walls,
        wall_s=wall, reads_per_s=n / wall, peak_bytes=peak,
        step_peak_bytes=peak - held, launches=launches, counters=counts,
        subset_reads=STEP_SUBSET, mask_decisions_differing=n_diff,
        mesh_wall_s=mesh_wall, profile=profile)
    print('step: ' + json.dumps(report))
    return launches


def _index_bytes(ref_path, lengths, k) -> list:
    """Device bytes of each shard's genome codes, int32 counts and
    positions, from the cache the cold run wrote."""
    lengths = np.asarray(lengths, np.int64)
    out = []
    with np.load(f'{ref_path}.fslr_k{k}.npz') as z:
        for si, (c0, c1) in enumerate(z['shard_bounds'].tolist()):
            n_pos = int(z[f'counts_{si}'][-1])
            out.append(int(lengths[c0:c1].sum()) + 4 * (4 ** k + 1)
                       + 4 * n_pos)
    return out


def _query_graph(data, dev, cfg, stats=None):
    from fslr_tpu_torch.stages.cluster import query_graph
    return query_graph(data, cfg.overlap, list(cfg.jaccard_cutoffs),
                       cfg.edge_threshold, cfg.qlen_diff,
                       cfg.n_alignment_diff, cfg, dev, stats)


def _graph_rows(graph) -> tuple:
    """(match rows sorted, edges in order, node order) of a query_graph
    result."""
    match, edges, node_pos = graph
    return sorted(match), edges, list(node_pos.items())


def _measured_graph(data, dev, cfg):
    """query_graph on ``dev``: (graph, stats with the wall time, each
    step's seconds from its span (``instrument.span``: ``tables_s``,
    ``enum_merge_s``, ...), the peak device bytes above what was held
    before and the bytes a read pair added)."""
    from fslr_tpu_torch.instrument import StageTimer, activate
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stats: dict = {}
    timer = StageTimer()
    t0 = time.perf_counter()
    with activate(timer):
        graph = _query_graph(data, dev, cfg, stats)
    stats['wall_s'] = time.perf_counter() - t0
    for step in ('tables', 'enum_merge', 'gate_order', 'value_replay',
                 'emit'):
        stats[f'{step}_s'] = timer.timings.get(step, 0.0)
    stats['peak_device_bytes'] = torch.cuda.max_memory_allocated() - base
    stats['peak_bytes_per_pair'] = (stats['peak_device_bytes']
                                    / max(stats['pairs'], 1))
    return graph, stats


def _same_graph(a, b, what):
    """Match rows, edges in order and node order of two query_graph
    results must be equal."""
    for i, part in ((1, 'edges'), (0, 'match rows')):
        if a[i] != b[i]:
            raise AssertionError(f'{what}: the {part} differ')
    if list(a[2].items()) != list(b[2].items()):
        raise AssertionError(f'{what}: the node order differs')


@contextlib.contextmanager
def _spill_direct_min(n: int):
    """Streams above ``n`` encounters go to the spill
    (ops/encounters.SPILL_DIRECT_MIN) while the block runs."""
    from fslr_tpu_torch.ops import encounters
    prev = encounters.SPILL_DIRECT_MIN
    encounters.SPILL_DIRECT_MIN = n
    try:
        yield
    finally:
        encounters.SPILL_DIRECT_MIN = prev


def _path_cfg(cfg, path: str):
    """(cfg, SPILL_DIRECT_MIN) that send a stream to ``path``."""
    from fslr_tpu_torch.ops import encounters
    spill_min = 1 << 62 if path == 'in-HBM' else 1
    return (dataclasses.replace(cfg, enum_spill_min_encounters=spill_min),
            0 if path == 'spill' else encounters.SPILL_DIRECT_MIN)


def _path_graph(data, dev, cfg, path: str):
    """_measured_graph through ``path``, which must be the path taken."""
    c, direct = _path_cfg(cfg, path)
    with _spill_direct_min(direct):
        graph, st = _measured_graph(data, dev, c)
    if st['path'] != path or 'fallback' in st:
        raise AssertionError(f'{path} asked, {st["path"]} taken '
                             f'({st.get("fallback")})')
    return graph, st


def run_cluster_scale(dev, smi: str) -> dict:
    """cluster-1m: the scale path of breakpoint clustering
    (ops/encounters.py, capwalk.resolve_device) through query_graph and
    get_subgraphs on the card, on tools/synth's cluster-scale data
    (CLUSTER_READS reads in groups of CLUSTER_GROUP, seed 7,
    exact_cap_replay off).  It must take the in-HBM path and give one
    cluster a group, and the edges of VERIFY_GROUPS groups spread over the
    pair keys must equal, in order, the host path's on each group alone.
    Then (a) the sharded path on the same data (more than one query
    bucket) must give the in-HBM graph; (b) SPILL_READS reads through the
    in-HBM, sharded and spill paths must agree; (c) CROSS_CLUSTER_READS
    reads on the card and on the CPU, in-HBM and sharded (both above
    device_enum_min_encounters); (d) get_subgraphs on (b)'s graph under
    the mesh (dev, dev) must equal it without a mesh; (e) SWEEP_CASES
    frames of tools/cap_sweep on the card and on the CPU must give the
    same records.  Prints the wall time, reads/s, each part's seconds,
    the sizes and the peak device memory of both cluster-1m runs; returns
    the in-HBM run's."""
    from fslr_tpu_torch.config import ClusterConfig
    from fslr_tpu_torch.parallel import dispatch
    from fslr_tpu_torch.parallel.mesh import Mesh
    from fslr_tpu_torch.stages.cluster import get_subgraphs
    from fslr_tpu_torch.tools import cap_sweep
    from fslr_tpu_torch.tools.synth import make_cluster_scale_data
    cfg = ClusterConfig(exact_cap_replay=False)
    t0 = time.perf_counter()
    data = make_cluster_scale_data(CLUSTER_READS, CLUSTER_GROUP, seed=7)
    data_s = time.perf_counter() - t0
    n_groups = CLUSTER_READS // CLUSTER_GROUP
    graph, stats = _measured_graph(data, dev, cfg)
    t1 = time.perf_counter()
    subgraphs = get_subgraphs(graph[1], graph[2], dev)
    components_s = time.perf_counter() - t1
    if stats['path'] != 'in-HBM':
        raise AssertionError(f'cluster-1m took the {stats["path"]} path')
    if len(subgraphs) != n_groups or \
            {len(c) for c in subgraphs} != {CLUSTER_GROUP}:
        raise AssertionError(f'cluster-1m: {len(subgraphs)} clusters, '
                             f'{n_groups} groups planted')
    # groups are 5 kb apart, so a group's walk depends on its entries
    # only: its edges (in order) must be the host path's on it alone
    vg = {int(g) for g in np.linspace(0, n_groups - 1, VERIFY_GROUPS)}
    by_group: dict = {g: [] for g in vg}
    for a, b in graph[1]:
        if a // CLUSTER_GROUP in vg:
            by_group[a // CLUSTER_GROUP].append((a, b))
    host = dataclasses.replace(cfg, device_enum_min_encounters=1 << 62)
    for g in sorted(vg):
        rows = [it for it in data if it.qname // CLUSTER_GROUP == g]
        want = _query_graph(rows, dev, host)[1]
        if not want or want != by_group[g]:
            raise AssertionError(f'cluster-1m group {g}: {len(want)} edges '
                                 f'on its own, {len(by_group[g])} at scale')
    del subgraphs, by_group
    phases = ('enum_merge_s', 'gate_order_s', 'value_replay_s', 'emit_s')

    def line(st, **extra):
        return dict(
            phase='cluster-1m', path=st['path'], reads=len(data),
            groups=n_groups, device=smi.splitlines()[0],
            query_graph_s=st['wall_s'],
            prepare_s=st['wall_s'] - sum(st[k] for k in phases),
            **{k: st[k] for k in phases}, encounters=st['encounters'],
            pairs=st['pairs'], entries=st['entries'], edges=st['edges'],
            peak_device_bytes=st['peak_device_bytes'],
            peak_bytes_per_pair=st['peak_bytes_per_pair'],
            **{k: st[k] for k in ('pk_buckets', 'query_buckets')
               if k in st}, **extra)

    wall = stats['wall_s'] + components_s
    out = line(stats, wall_s=wall, reads_per_s=len(data) / wall,
               data_build_s=data_s, components_s=components_s,
               clusters=n_groups, verified_groups=len(vg))
    print(json.dumps(out))

    # (a) the sharded path on the same data gives the in-HBM graph
    sharded, st = _path_graph(data, dev, cfg, 'sharded')
    if st['query_buckets'] < 2:
        raise AssertionError(f'cluster-1m sharded: {st["query_buckets"]} '
                             'query bucket')
    _same_graph(graph, sharded, 'cluster-1m sharded vs in-HBM')
    print(json.dumps(line(st)))
    del graph, sharded, data

    # (b) in-HBM == sharded == spill
    data = make_cluster_scale_data(SPILL_READS, CLUSTER_GROUP, seed=7)
    got = {}
    for path in ('in-HBM', 'sharded', 'spill'):
        got[path], st = _path_graph(data, dev, cfg, path)
        print(f'cluster {len(data)} reads {path}: {st["wall_s"]:.3f} s, '
              f'{st["entries"]} entries, {st["edges"]} edges, peak '
              f'{st["peak_device_bytes"]} B')
    for path in ('sharded', 'spill'):
        _same_graph(got['in-HBM'], got[path], f'cluster: {path} vs in-HBM')

    # (d) the mesh merge of the components, timed in turns against the
    # call without a mesh
    _, edges, node_pos = got['in-HBM']
    res, secs = {}, {'plain': [], 'mesh': []}
    for kind in ('plain', 'mesh', 'mesh', 'plain'):
        t0 = time.perf_counter()
        with (dispatch.use_mesh(Mesh((dev, dev))) if kind == 'mesh'
              else contextlib.nullcontext()):
            res[kind] = get_subgraphs(edges, node_pos, dev)
        secs[kind].append(time.perf_counter() - t0)
    plain = res['plain']
    if res['mesh'] != plain or len(plain) != len(data) // CLUSTER_GROUP:
        raise AssertionError('cluster: get_subgraphs on the mesh differs')
    print(json.dumps(dict(phase='cluster-mesh-merge', reads=len(data),
                          edges=len(edges), components=len(plain),
                          mesh=f'({dev}, {dev})', plain_s=secs['plain'],
                          mesh_s=secs['mesh'])))
    del got, res, plain, edges, node_pos

    # (c) card == CPU, in-HBM and sharded, above device_enum_min_encounters
    data = make_cluster_scale_data(CROSS_CLUSTER_READS, CLUSTER_GROUP,
                                   seed=7)
    for path in ('in-HBM', 'sharded'):
        c, _ = _path_cfg(cfg, path)
        got = []
        for d in (dev, torch.device('cpu')):
            st = {}
            t0 = time.perf_counter()
            got.append(_query_graph(data, d, c, st))
            if st['path'] != path or \
                    st['encounters'] < cfg.device_enum_min_encounters:
                raise AssertionError(f'card vs CPU: {st}')
            print(f'cluster {len(data)} reads {path} on {d.type}: '
                  f'{time.perf_counter() - t0:.3f} s, {st["encounters"]} '
                  f'encounters, {st["edges"]} edges')
        _same_graph(got[0], got[1], f'cluster {path}: card vs CPU')

    # (e) a short cap sweep, card == CPU
    recs = []
    for d in (dev, torch.device('cpu')):
        t0 = time.perf_counter()
        recs.append(cap_sweep.sweep(SWEEP_CASES, 1, d))
        print(f'cap sweep on {d.type}: {time.perf_counter() - t0:.3f} s, '
              + json.dumps(cap_sweep.totals(recs[-1])))
    if recs[0] != recs[1]:
        raise AssertionError('cap sweep: the card and the CPU differ')
    torch.cuda.empty_cache()
    return out


def cluster_paths(dev, n_reads: int, paths=('in-HBM', 'sharded', 'spill')):
    """One-off measurement, not run by default: query_graph on ``n_reads``
    reads of tools/synth's cluster-scale data (groups of CLUSTER_GROUP)
    through each of ``paths``; a JSON line a path with its wall time,
    each part's seconds, the sizes, the peak device bytes (and a read
    pair's share), the process's peak host memory so far and a digest of
    its edges and node order, which must agree between the paths.

        python3 -c "import torch, chip_smoke as c;
        c.cluster_paths(torch.device('cuda'), 2_000_000)"
    """
    import hashlib
    import itertools
    import resource
    from fslr_tpu_torch.config import ClusterConfig
    from fslr_tpu_torch.tools.synth import make_cluster_scale_data
    cfg = ClusterConfig(exact_cap_replay=False)
    t0 = time.perf_counter()
    data = make_cluster_scale_data(n_reads, CLUSTER_GROUP, seed=7)
    print(json.dumps(dict(reads=len(data),
                          data_build_s=time.perf_counter() - t0)),
          flush=True)
    out = {}
    for path in paths:
        graph, st = _path_graph(data, dev, cfg, path)
        _, edges, node_pos = graph
        del graph
        h = hashlib.sha256()
        h.update(np.fromiter(itertools.chain.from_iterable(edges),
                             np.int64, 2 * len(edges)).tobytes())
        h.update(np.fromiter(node_pos, np.int64, len(node_pos)).tobytes())
        del edges, node_pos
        st['digest'] = h.hexdigest()[:16]
        st['host_peak_rss_bytes'] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024
        out[path] = st
        print(json.dumps(dict(reads=len(data), **st)), flush=True)
    if len({st['digest'] for st in out.values()}) > 1:
        raise AssertionError('cluster_paths: the paths differ')
    torch.cuda.empty_cache()
    return out


def make_human(root):
    """The human-3g dataset under ``root``, in a process of its own
    (human_dataset_beside); writes its paths and seconds to
    ``root/dataset.json``."""
    from fslr_tpu_torch.tools.synth import make_grch38_layout_dataset
    t0 = time.perf_counter()
    paths = make_grch38_layout_dataset(root, HUMAN_READS, HUMAN_GROUPS)
    with open(os.path.join(root, 'dataset.json'), 'w') as fh:
        json.dump(dict(paths=paths, seconds=time.perf_counter() - t0), fh)


@contextlib.contextmanager
def human_dataset_beside(root):
    """make_human in the background for the block (from the start of
    phase 10, with no card visible), under ``root/human``.  Yields
    (process, its root); the process is stopped when the block ends."""
    root = os.path.join(root, 'human')
    os.makedirs(root)
    with open(os.path.join(root, 'dataset.err'), 'w') as err:
        proc = subprocess.Popen(
            [sys.executable, '-c',
             f'import chip_smoke; chip_smoke.make_human({root!r})'],
            stdout=subprocess.DEVNULL, stderr=err,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    try:
        yield proc, root
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def run_human(dev, dataset) -> dict:
    """human-3g: 10,000 reads against a GRCh38-size reference (24
    chromosomes at GRCh38's lengths, 3.09 Gbp, 4 index shards) with
    --reference-mask, exact CIGARs and --skip-clustering, through the
    CLI: cold (the device builds the sharded index and writes its cache),
    then warm (the cache is read back).  Both must launch the slice's
    kernels, find the planted chrX segment in >= 99% of the reads, map
    only to chr1 and chrX and leave no temporary reference; the warm run's
    artifacts must equal the cold run's, the cold BAM's AS tags their
    replays.  The dataset comes from ``dataset`` (human_dataset_beside).
    Returns the cold run's launch counts."""
    from fslr_tpu_torch.tools.synth import GRCH38
    proc, root = dataset
    for cmd in (['df', '-h', root], ['free', '-g']):
        print('human: ' + subprocess.run(cmd, capture_output=True,
                                         text=True).stdout.strip())
    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    if rc:
        with open(os.path.join(root, 'dataset.err')) as fh:
            raise AssertionError(f'human dataset: rc {rc}\n'
                                 + fh.read()[-3000:])
    with open(os.path.join(root, 'dataset.json')) as fh:
        made = json.load(fh)
    ref, fq, mask = made['paths']
    print(f'human: dataset {made["seconds"]:.2f} s in the background, '
          f'waited {time.perf_counter() - t0:.2f} s '
          f'({sum(n for _, n in GRCH38)} bp in {len(GRCH38)} contigs)')
    span = group_span(dict(GRCH38)['chrX'], HUMAN_GROUPS)
    k = PipelineConfig().align.seed_k
    bases, out = [], {}
    for tag in ('cold', 'warm'):
        base, wall, launches, peak, stages = _run_measured(
            root, ref, fq, f'human_{tag}', dev, True, SLICE_PATH, mask=mask)
        rows = _read_bed(base + '.mappings.bed')
        recall = _recall(rows, 'chrX', span, HUMAN_READS)
        if recall < 0.99:
            raise AssertionError(f'human ({tag}): planted chrX segment '
                                 f'found in {recall:.4f} of reads')
        # a random genome shares 11-mers with the reads' primer targets:
        # short anchors (< 50 bp) may land on any chromosome
        genomic = [r for r in rows if r['inferred_by_primer'] == '0']
        chroms = {r['chrom'] for r in genomic if int(r['aln_size']) >= 50}
        elsewhere = [r for r in genomic if r['chrom'] not in chroms]
        if chroms != {'chr1', 'chrX'}:
            raise AssertionError(f'human ({tag}): alignments of 50 bp or '
                                 f'more on {sorted(chroms)}')
        left = [n for n in os.listdir(os.path.dirname(base))
                if '_temp_ref.fa' in n]
        if left:
            raise AssertionError(f'human ({tag}): {left} left behind')
        split = {n: round(v, 3) for n, v in stages.items()
                 if n.startswith('index_') or 'load' in n}
        print(f'human ({tag}): {HUMAN_READS} reads, pipeline {wall:.2f} s, '
              f'{HUMAN_READS / wall:.1f} reads/s, peak device memory '
              f'{peak / 2**30:.3f} GiB, chrX recall {recall:.4f}, bed rows '
              f'{len(rows)}, alignments of >= 50 bp on {sorted(chroms)}, '
              f'{len(elsewhere)} shorter ones elsewhere (longest '
              f'{max((int(r["aln_size"]) for r in elsewhere), default=0)} '
              'bp)')
        print(f'human ({tag}) load_index split (s): ' + json.dumps(split))
        print(f'human ({tag}) stages (s): ' + json.dumps(stages))
        print(f'human ({tag}) launches: ' + json.dumps(launches))
        bases.append(base)
        out[tag] = launches
    shard_bytes = _index_bytes(ref, [n for _, n in GRCH38], k)
    if len(shard_bytes) != HUMAN_SHARDS:
        raise AssertionError(f'{len(shard_bytes)} shards, not '
                             f'{HUMAN_SHARDS}')
    print(f'human: {len(shard_bytes)} shards, device bytes {shard_bytes} '
          f'(total {sum(shard_bytes) / 2**30:.3f} GiB)')
    for suffix in ('.mappings.bed', '.filter_counts_summary.csv',
                   '.bwa_dodi.bam'):
        _same(bases[0] + suffix, bases[1] + suffix, f'human {suffix}')
    print('human: warm == cold for mappings.bed, filter_counts_summary.csv '
          'and BAM records')
    t0 = time.perf_counter()
    bam = check_bam(bases[0], ref, mask)
    print(f'human BAM: {json.dumps(bam)}, checked in '
          f'{time.perf_counter() - t0:.2f} s')
    check_parse(ref)
    return out['cold']


def check_parse(ref_path):
    """load_reference's bulk FASTA parse against a parse record by record
    (read_fastx + encode, the port's load_reference before the bulk
    one): the same names and codes.  Prints both times."""
    from fslr_tpu_torch.encode import encode
    from fslr_tpu_torch.index.reference import load_reference
    from fslr_tpu_torch.io.fastq import read_fastx
    t0 = time.perf_counter()
    bulk = load_reference(ref_path)
    t_bulk = time.perf_counter() - t0
    t0 = time.perf_counter()
    names, parts = [], []
    for rec in read_fastx(ref_path):
        names.append(rec.name)
        parts.append(encode(rec.sequence))
    codes = np.concatenate(parts)
    t_records = time.perf_counter() - t0
    if names != bulk.names or not np.array_equal(codes, bulk.codes):
        raise AssertionError('bulk FASTA parse differs from read_fastx')
    print(f'parse: {len(codes)} bases in {len(names)} contigs, bulk '
          f'(load_reference) {t_bulk:.3f} s, record by record (read_fastx '
          f'+ encode) {t_records:.3f} s')


# ---------------------------------------------------------------------------
# Phase 12: the multi-card path (python3 chip_smoke.py --cards N)
# ---------------------------------------------------------------------------

CARDS_DEFAULT = 4


def _distinct(cards) -> list:
    """The cards of ``cards``, each once, in order."""
    return list(dict.fromkeys(cards))


def _sync(cards):
    for d in _distinct(cards):
        torch.cuda.synchronize(d)


def _card_keys(by_card: dict) -> dict:
    """{card index: n} from a JSON object (its keys are strings)."""
    return {int(k): v for k, v in by_card.items()}


def _summed(by_cards) -> dict:
    """{card index: sum} over objects {card: n} (JSON's keys are
    strings)."""
    out: dict = {}
    for by in by_cards:
        for card, v in _card_keys(by).items():
            out[card] = out.get(card, 0) + v
    return out


def _on_every_card(by_card: dict, names, cards, what):
    """Each kernel of ``names`` must have been launched on every card of
    ``cards`` (``by_card``: {kernel: {card index: launches}})."""
    for name in names:
        got = _card_keys(by_card[name])
        missing = [d.index for d in _distinct(cards)
                   if got.get(d.index, 0) <= 0]
        if missing:
            raise AssertionError(f'{what}: {name} was not launched on '
                                 f'cards {missing}')


def _card_run(cards, argv) -> dict:
    """The CLI's run of ``argv`` (with --name and --out) on ``cards``: on
    one card with --mesh-devices 1, on several with the mesh the CLI
    gives them (--mesh-devices 0 when they are every visible card; a card
    named several times, as in a rehearsal on one card, is meshed as
    named).  Launch counts and each card's peak memory are set to 0 just
    before it.  Returns its base path, wall seconds, launches by card,
    peak bytes by card and stage seconds."""
    from fslr_tpu_torch.cli import _parser, config_from_args, mesh_from_args
    from fslr_tpu_torch.parallel.mesh import Mesh
    from fslr_tpu_torch.pipeline import run_pipeline
    dev = cards[0]
    flag = ('1' if len(cards) == 1 else
            '0' if len(cards) == torch.cuda.device_count() else
            str(len(cards)))
    args = _parser().parse_args(argv + ['--device', str(dev),
                                        '--mesh-devices', flag])
    mesh = (mesh_from_args(args, dev) if len(set(cards)) == len(cards)
            else Mesh(tuple(cards)))
    if (mesh.devices if mesh else (dev,)) != tuple(cards):
        raise AssertionError(f'the CLI meshes {mesh}, not {cards}')
    _sync(cards)
    for d in _distinct(cards):
        torch.cuda.reset_peak_memory_stats(d)
    kernels.reset_launches()
    t0 = time.perf_counter()
    run_pipeline(config_from_args(args), dev, mesh=mesh)
    _sync(cards)
    wall = time.perf_counter() - t0
    base = os.path.join(args.out, args.name)
    with open(base + '.timings.json') as fh:
        stages = json.load(fh)['timings_s']
    return dict(base=base, wall_s=wall,
                launches=kernels.launch_counts(by_device=True),
                peak_bytes={d.index: torch.cuda.max_memory_allocated(d)
                            for d in _distinct(cards)},
                stages=stages)


def _same_outputs(a: str, b: str, what: str) -> int:
    """Every file under run folders ``a`` and ``b`` byte-equal, but the
    timings and the consensus stage's reads without primers, which are
    named by a uuid (as in ``_tree``); returns how many."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(dp, n), root)
                      for dp, _, names in os.walk(root) for n in names
                      if not n.endswith(('.timings.json', '.no_primers.fq')))
    fa, fb = files(a), files(b)
    if fa != fb:
        raise AssertionError(f'{what}: the files differ: '
                             f'{sorted(set(fa) ^ set(fb))}')
    for rel in fa:
        with open(os.path.join(a, rel), 'rb') as x, \
                open(os.path.join(b, rel), 'rb') as y:
            if x.read() != y.read():
                raise AssertionError(f'{what}: {rel} differs')
    return len(fa)


def _run_line(run: str, r: dict, reads: int) -> dict:
    return dict(run=run, wall_s=r['wall_s'], reads_per_s=reads / r['wall_s'],
                peak_bytes=r['peak_bytes'])


def cards_kernels(cards) -> dict:
    """(a) Every kernel on every card against its plain version there, by
    phase 3's rules (check_kernels, timed on the first card only).
    Returns {card index: check_kernels' result}."""
    out = {}
    for i, d in enumerate(_distinct(cards)):
        t0 = time.perf_counter()
        with torch.cuda.device(d):
            out[d.index] = check_kernels(d, timed=i == 0)
        print(f'cards (a): every kernel on {d} == its plain version '
              f'({time.perf_counter() - t0:.1f} s)', flush=True)
    return out


def cards_slice(cards, root) -> dict:
    """(b) slice-10k through the CLI on the mesh of ``cards``: every
    artifact, BAM and index included, byte-equal to one card's cold and
    warm runs, every slice kernel launched on every card.  Returns the
    data and the mesh run."""
    root = os.path.join(root, 'cards_slice')
    os.makedirs(root)
    ref, fq = make_dataset(root, SLICE_READS, 20, ref_mb=SLICE_REF_BP)

    def argv(tag):
        return ['--name', 'S', '--out', os.path.join(root, f'out_{tag}'),
                '--ref', ref, '--primers', '21q1,17p6', '--basecalled', fq,
                '--skip-clustering']

    one_cold = _card_run(cards[:1], argv('one_cold'))
    mesh = _card_run(cards, argv('mesh'))
    one = _card_run(cards[:1], argv('one'))
    for r, what in ((one_cold, 'one card, cold'), (one, 'one card')):
        n = _same_outputs(os.path.dirname(r['base']),
                          os.path.dirname(mesh['base']),
                          f'slice-10k on {len(cards)} cards vs {what}')
    _on_every_card(mesh['launches'], SLICE_PATH, cards, 'slice-10k')
    recall = _recall(_read_bed(mesh['base'] + '.mappings.bed'), 'chrB',
                     group_span(SLICE_REF_BP, 20), SLICE_READS)
    if recall < 0.99:
        raise AssertionError(f'slice-10k on the cards: recall {recall}')
    print('cards (b): ' + json.dumps(dict(
        phase='cards-slice', cards=[str(d) for d in cards],
        artifacts_byte_equal=n, recall=recall,
        runs=[_run_line('one card, cold', one_cold, SLICE_READS),
              _run_line(f'{len(cards)} cards', mesh, SLICE_READS),
              _run_line('one card', one, SLICE_READS)],
        launches=mesh['launches'],
        stages={'one card': one['stages'],
                f'{len(cards)} cards': mesh['stages']})), flush=True)
    return dict(ref=ref, fq=fq, launches=mesh['launches'])


def cards_consensus(cards, root) -> dict:
    """(c) consensus-10k (clustering and --consensus) on the mesh of
    ``cards``: every artifact (cluster beds, FASTAs, counts, BAMs)
    byte-equal to one card's run, every kernel, prof_kernel included,
    launched on every card.  Returns the mesh run's launches by card."""
    root = os.path.join(root, 'cards_consensus')
    os.makedirs(root)
    ref, fq = make_dataset(root, CONS_READS, CONS_GROUPS)
    runs = {}
    for tag, cs in (('one', cards[:1]), ('mesh', cards)):
        runs[tag] = _card_run(cs, [
            '--name', 'S', '--out', os.path.join(root, f'out_{tag}'),
            '--ref', ref, '--primers', '21q1,17p6', '--basecalled', fq,
            '--consensus'])
    n = _same_outputs(os.path.dirname(runs['one']['base']),
                      os.path.dirname(runs['mesh']['base']),
                      f'consensus-10k on {len(cards)} cards vs one card')
    planted, clusters = check_clusters(runs['mesh']['base'], CONS_READS,
                                       CONS_GROUPS, CONS_REF_BP)
    _on_every_card(runs['mesh']['launches'], KERNELS, cards,
                   'consensus-10k')
    print('cards (c): ' + json.dumps(dict(
        phase='cards-consensus', cards=[str(d) for d in cards],
        artifacts_byte_equal=n, clusters=clusters, planted=planted,
        runs=[_run_line('one card', runs['one'], CONS_READS),
              _run_line(f'{len(cards)} cards', runs['mesh'], CONS_READS)],
        launches=runs['mesh']['launches'],
        stages={'one card': runs['one']['stages'],
                f'{len(cards)} cards': runs['mesh']['stages']})),
        flush=True)
    return runs['mesh']['launches']


def _replicate_s(cards, sizes) -> list:
    """Seconds of ``parallel.mesh.replicate`` of tensors of ``sizes``
    bytes from the first card to each other card, twice each."""
    from fslr_tpu_torch.parallel.mesh import Mesh, replicate
    src = [torch.empty(b, dtype=torch.uint8, device=cards[0]) for b in sizes]
    out = []
    for d in _distinct(cards)[1:]:
        secs = []
        for _ in range(2):
            _sync((cards[0], d))
            t0 = time.perf_counter()
            copies = replicate(Mesh((cards[0], d)), *src)
            _sync((cards[0], d))
            secs.append(time.perf_counter() - t0)
            del copies
        out.append(dict(card=str(d), seconds=secs,
                        gb_per_s=sum(sizes) / min(secs) / 1e9))
    del src
    torch.cuda.empty_cache()
    return out


def cards_human(cards, root) -> dict:
    """(d) human-3g (--reference-mask, 4 shards) cold on one card, then
    cold and warm on the mesh of ``cards`` (every card holds the whole
    index): recall >= 0.99, every artifact byte-equal to the one card's,
    the slice kernels launched on every card; the replication of the
    index's bytes to each other card timed alone.  Returns the cold mesh
    run's launches by card."""
    from fslr_tpu_torch.tools.synth import (GRCH38,
                                            make_grch38_layout_dataset)
    root = os.path.join(root, 'cards_human')
    os.makedirs(root)
    t0 = time.perf_counter()
    ref, fq, mask = make_grch38_layout_dataset(root, HUMAN_READS,
                                               HUMAN_GROUPS)
    data_s = time.perf_counter() - t0
    k = PipelineConfig().align.seed_k
    cache = f'{ref}.fslr_k{k}.npz'
    runs = {}
    for tag, cs in (('one card, cold', cards[:1]),
                    (f'{len(cards)} cards, cold', cards),
                    (f'{len(cards)} cards, warm', cards)):
        if tag.endswith('cold') and os.path.exists(cache):
            os.remove(cache)
        runs[tag] = _card_run(cs, [
            '--name', 'S', '--out', os.path.join(root, f'out_{len(runs)}'),
            '--ref', ref, '--primers', '21q1,17p6', '--basecalled', fq,
            '--skip-clustering', '--reference-mask', mask])
    one, cold, warm = runs.values()
    for tag, r in list(runs.items())[1:]:
        n_same = _same_outputs(os.path.dirname(one['base']),
                               os.path.dirname(r['base']),
                               f'human-3g, {tag} vs one card')
        _on_every_card(r['launches'], SLICE_PATH, cards, f'human-3g, {tag}')
    recall = _recall(_read_bed(cold['base'] + '.mappings.bed'), 'chrX',
                     group_span(dict(GRCH38)['chrX'], HUMAN_GROUPS),
                     HUMAN_READS)
    if recall < 0.99:
        raise AssertionError(f'human-3g on the cards: recall {recall}')
    sizes = _index_bytes(ref, [length for _, length in GRCH38], k)
    if len(sizes) != HUMAN_SHARDS:
        raise AssertionError(f'{len(sizes)} shards, not {HUMAN_SHARDS}')
    print('cards (d): ' + json.dumps(dict(
        phase='cards-human-3g', cards=[str(d) for d in cards],
        dataset_s=data_s, artifacts_byte_equal=n_same, recall=recall,
        index_bytes=sizes,
        runs=[_run_line(tag, r, HUMAN_READS) for tag, r in runs.items()],
        index_upload_s={tag: r['stages'].get('index_upload')
                        for tag, r in runs.items()},
        replicate=_replicate_s(cards, sizes),
        launches=cold['launches'],
        stages={tag: r['stages'] for tag, r in runs.items()})), flush=True)
    return cold['launches']


def cards_step(cards, ref_path, fq_dir) -> dict:
    """(e) The fused step on slice-10k's reads at L = 3072 over the mesh
    of ``cards`` (make_sharded_step) against one card's step: equal
    outputs, counters included, the step's kernels launched on every
    card, warm calls timed in turns (1, N, N, 1).  Returns the sharded
    call's launches by card."""
    from fslr_tpu_torch.io.fastq import read_fastx
    from fslr_tpu_torch.parallel.mesh import Mesh
    from fslr_tpu_torch.parallel.step import (make_device_step,
                                              make_sharded_step)
    from fslr_tpu_torch.tools.synth import step_inputs
    dev = cards[0]
    seqs = [r.sequence for f in sorted(os.listdir(fq_dir))
            for r in read_fastx(os.path.join(fq_dir, f))]
    args = step_inputs(ref_path, seqs, STEP_L, dev)
    config = PipelineConfig()
    NP = int(args[2].shape[0])
    n_seed = (STEP_L - config.align.seed_k) // config.align.seed_stride + 1
    steps = {1: make_device_step(config, NP, STEP_L, n_seed),
             len(cards): make_sharded_step(Mesh(tuple(cards)), config, NP,
                                           STEP_L, n_seed)}
    want = steps[1](*args)
    _sync(cards)
    kernels.reset_launches()
    got = steps[len(cards)](*args)
    _sync(cards)
    launches = kernels.launch_counts(by_device=True)
    _on_every_card(launches, STEP_PATH, cards, 'the fused step')
    _same_step(got, want, f'the fused step on {len(cards)} cards')
    del got, want
    secs = {1: [], len(cards): []}
    for n in (1, len(cards), len(cards), 1):
        _sync(cards)
        t0 = time.perf_counter()
        steps[n](*args)
        _sync(cards)
        secs[n].append(time.perf_counter() - t0)
    print('cards (e): ' + json.dumps(dict(
        phase='cards-step', cards=[str(d) for d in cards], reads=len(seqs),
        L=STEP_L, one_card_s=secs[1], cards_s=secs[len(cards)],
        launches=launches)), flush=True)
    return launches


def cards_processes(cards, root) -> dict:
    """(f) consensus-10k as PAR_FILES files in one CLI process a card
    (--device cuda:i --mesh-devices 1) and, as the CLI's default there,
    with --mesh-devices 0 (each process meshes every card from its own),
    each against one process on the first card: beds, FASTAs, purity CSV
    and counts byte-equal, BAM records equal as a multiset; every card
    launched kernels.  Then get_subgraphs on the mesh of ``cards`` at
    SPILL_READS reads against the plain call, in turns.  Returns the
    launches by card summed over the one-process-a-card run."""
    from fslr_tpu_torch.config import ClusterConfig
    from fslr_tpu_torch.parallel import dispatch
    from fslr_tpu_torch.parallel.mesh import Mesh
    from fslr_tpu_torch.stages.cluster import get_subgraphs
    from fslr_tpu_torch.tools.synth import make_cluster_scale_data
    root = os.path.join(root, 'cards_processes')
    os.makedirs(root)
    ref, fq = make_dataset(root, CONS_READS, CONS_GROUPS)
    n = _split_reads(fq, PAR_FILES)
    argv = ['--name', 'C', '--ref', ref, '--primers', '21q1,17p6',
            '--basecalled', fq, '--consensus', '--mesh-devices']
    runs, outs, pers = [], {}, {}
    for tag, cs, flag in (('one process', cards[:1], '1'),
                          (f'{len(cards)} processes', cards, '1'),
                          (f'{len(cards)} processes, --mesh-devices 0',
                           cards, '0')):
        outs[tag] = os.path.join(root, f'out_{len(outs)}')
        wall, _, pers[tag] = _processes(argv + [flag], outs[tag], root, cs)
        for pid, p in enumerate(pers[tag]):
            if not _summed(p['launches'].values()).get(cs[pid].index):
                raise AssertionError(f'{tag}: process {pid} launched no '
                                     f'kernel on {cs[pid]}')
        runs.append(dict(run=tag, wall_s=wall, reads_per_s=n / wall,
                         peak_bytes_summed_over_processes=_summed(
                             p['peak_bytes'] for p in pers[tag]),
                         launches=[p['launches'] for p in pers[tag]]))
    first = next(iter(outs.values()))
    same = {tag: _same_trees(first, out, tag)
            for tag, out in list(outs.items())[1:]}
    print('cards (f): ' + json.dumps(dict(
        phase='cards-processes', cards=[str(d) for d in cards], reads=n,
        files=PAR_FILES, artifacts_equal=same, runs=runs)), flush=True)

    data = make_cluster_scale_data(SPILL_READS, CLUSTER_GROUP, seed=7)
    _, edges, node_pos = _query_graph(data, cards[0],
                                      ClusterConfig(exact_cap_replay=False))
    res, secs = {}, {'plain': [], 'mesh': []}
    for kind in ('plain', 'mesh', 'mesh', 'plain'):
        t0 = time.perf_counter()
        with (dispatch.use_mesh(Mesh(tuple(cards))) if kind == 'mesh'
              else contextlib.nullcontext()):
            res[kind] = get_subgraphs(edges, node_pos, cards[0])
        secs[kind].append(time.perf_counter() - t0)
    if res['mesh'] != res['plain'] or \
            len(res['plain']) != len(data) // CLUSTER_GROUP:
        raise AssertionError(f'get_subgraphs on {len(cards)} cards differs')
    print('cards (f): ' + json.dumps(dict(
        phase='cards-mesh-merge', reads=len(data), edges=len(edges),
        components=len(res['plain']), cards=[str(d) for d in cards],
        plain_s=secs['plain'], mesh_s=secs['mesh'])), flush=True)
    return {k: _summed(p['launches'][k]
                       for p in pers[f'{len(cards)} processes'])
            for k in KERNELS}


def cards_default_human(cards, root) -> dict:
    """Not run by phase 12, since running out of memory is one of its
    answers: human-3g cold, its reads as PAR_FILES files, in one CLI
    process a card with the CLI's default (--mesh-devices 0: each process
    meshes every card from its own, so each card holds one copy of the
    index a process) against one process on the first card
    (--mesh-devices 1).  Prints each run's wall and each card's peak
    device memory summed over the processes, whether their artifacts are
    equal, or the tail of the log of a process that failed:

        python3 -c "import tempfile, torch, chip_smoke as c;
        c.build_kernels(); c.cards_default_human([torch.device('cuda', i)
        for i in range(4)], tempfile.mkdtemp())"
    """
    from fslr_tpu_torch.tools.synth import make_grch38_layout_dataset
    root = os.path.join(root, 'cards_default_human')
    os.makedirs(root)
    ref, fq, mask = make_grch38_layout_dataset(root, HUMAN_READS,
                                               HUMAN_GROUPS)
    n = _split_reads(fq, PAR_FILES)
    cache = f'{ref}.fslr_k{PipelineConfig().align.seed_k}.npz'
    argv = ['--name', 'S', '--ref', ref, '--primers', '21q1,17p6',
            '--basecalled', fq, '--skip-clustering', '--reference-mask',
            mask, '--mesh-devices']
    runs, outs = {}, []
    for tag, cs, flag in (('one process', cards[:1], '1'),
                          (f'{len(cards)} processes, --mesh-devices 0',
                           cards, '0')):
        if os.path.exists(cache):
            os.remove(cache)                     # each run cold
        outs.append(os.path.join(root, f'out_{len(outs)}'))
        try:
            wall, _, per = _processes(argv + [flag], outs[-1], root, cs)
        except AssertionError as e:     # a failed process is the finding
            runs[tag] = dict(failed=str(e)[-1500:])
            continue
        runs[tag] = dict(wall_s=wall, reads_per_s=n / wall,
                         peak_bytes_summed_over_processes=_summed(
                             p['peak_bytes'] for p in per))
    equal = (_same_trees(*outs, 'human-3g, the CLI default')
             if all('failed' not in r for r in runs.values()) else None)
    out = dict(phase='cards-default-human-3g',
               cards=[str(d) for d in cards], reads=n, files=PAR_FILES,
               artifacts_equal=equal, runs=runs)
    print(json.dumps(out), flush=True)
    return out


def run_cards(cards, root) -> dict:
    """Phase 12 on ``cards`` (a list of torch.device; a card may be named
    several times to rehearse the control flow on one card): (a) every
    kernel on every card, (b) slice-10k, (e) the fused step, (c)
    consensus-10k, (f) processes and the mesh merge, (d) human-3g (last:
    it holds the most memory).  Returns the kernels' checks and launches
    by card of each part."""
    checks = cards_kernels(cards)
    sl = cards_slice(cards, root)
    out = dict(checks=checks, slice=sl['launches'],
               step=cards_step(cards, sl['ref'], sl['fq']),
               consensus=cards_consensus(cards, root),
               processes=cards_processes(cards, root),
               human=cards_human(cards, root))
    return out


DP_WRAPPERS = {   # the banded DP kernels: module, wrapper, (narrow, wide)
    'banded_kernel': (banded, '_banded_cuda', banded.LAYOUTS),
    'tb_kernel': (traceback, '_tb_cuda', traceback.LAYOUTS),
}
WRAPPERS = {   # every kernel: module, its CUDA wrapper
    'mask_kernel': (tantan, '_posterior_cuda'),
    'sw_packed_kernel': (ssw, '_sw_packed_cuda'),
    'sw_kernel': (ssw, '_sw_cuda'),
    'banded_kernel': (banded, '_banded_cuda'),
    'tb_kernel': (traceback, '_tb_cuda'),
    'walk_kernel': (traceback, '_walk_cuda'),
    'prof_kernel': (profile_align, '_prof_cuda'),
}
SW_KERNELS = ('sw_kernel', 'sw_packed_kernel')
# kernels whose inputs own_launches saves; the walk runs on the codes that
# a tree's own tb and prof kernels make from theirs
SAVED = SW_KERNELS + ('tb_kernel', 'prof_kernel')


def _bench_line(mode: str, line: dict, smi: str) -> dict:
    """A JSON line of the bench's ``mode``: exactly bench.py's keys and
    'device', which must be the card as nvidia-smi names it (name, power
    limit), also named in the metric, which never says TPU."""
    card = smi.splitlines()[0]
    want = BENCH_KEYS[mode] | {'device'}
    if mode == 'default' and 'reads_per_s_10k' not in line:
        want = {k for k in want if not k.endswith('_10k')}
    if set(line) != want:
        raise AssertionError(f'bench {mode}: keys {sorted(set(line) ^ want)} '
                             'differ from bench.py\'s')
    if line['device'] != card or card not in line['metric'] or \
            'TPU' in line['metric']:
        raise AssertionError(f'bench {mode}: {line["metric"]!r} does not '
                             f'name the card ({card})')
    return line


def _bench_process(args, mode: str, smi: str) -> tuple:
    """``python -m fslr_tpu_torch.bench ARGS`` from the repository root, as
    a user runs it: exactly one JSON line on stdout (_bench_line).
    Returns (line, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'fslr_tpu_torch.bench', *args],
        capture_output=True, text=True, timeout=1200,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f'bench {args}: rc {proc.returncode}\n'
                             + proc.stderr[-3000:])
    lines = proc.stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError(f'bench {args}: {len(lines)} lines on stdout')
    return _bench_line(mode, json.loads(lines[0]), smi), secs


def _bed_columns(path, cols) -> list:
    """The columns ``cols`` of a bed with a header, as lists of strings
    (a bed of a 1M-read run has 4.45M rows: no dict a row)."""
    with open(path, newline='') as fh:
        rd = csv.reader(fh, delimiter='\t')
        head = next(rd)
        idx = [head.index(c) for c in cols]
        out: list = [[] for _ in cols]
        for row in rd:
            for o, i in zip(out, idx):
                o.append(row[i])
    return out


def _read_id(qname: str) -> int:
    return int(qname.split('.')[0][1:])


def rows_by_read(path, n_reads) -> np.ndarray:
    """mappings.bed rows of each read r{i}, i < n_reads."""
    (qn,) = _bed_columns(path, ['qname'])
    return np.bincount(np.fromiter((_read_id(q) for q in qn), np.int64,
                                   len(qn)), minlength=n_reads)


def planted_clusters(base, n_reads, n_groups, ref_bp) -> tuple:
    """A clustered run held to the planted truth: each group outside the
    subtelomere mask (read r{i} is in group i % n_groups) is one cluster
    of exactly its reads, and a read has one cluster.  Returns ({planted
    cluster: its group}, {cluster: its reads})."""
    span = group_span(ref_bp, n_groups)
    qn, cl = _bed_columns(base + '.mappings.cluster.bed',
                          ['qname', 'cluster'])
    cluster_of: dict = {}
    for q, c in zip(qn, cl):
        i, c = _read_id(q), int(float(c))
        if cluster_of.setdefault(i, c) != c:
            raise AssertionError(f'read r{i} is in clusters '
                                 f'{cluster_of[i]} and {c}')
    members: dict = {}
    for i, c in cluster_of.items():
        members.setdefault(c, set()).add(i)
    planted = {}
    for g in range(n_groups):
        if 600_000 + g * span + 1000 > ref_bp - SUBTELOMERE:
            continue
        c = cluster_of.get(g)
        if c is None or members[c] != set(range(g, n_reads, n_groups)):
            raise AssertionError(f'group {g} is not one cluster of its '
                                 'reads')
        planted[c] = g
    return planted, members


def scale_run(dev, root, n_reads, n_groups, smi) -> dict:
    """``fslr_tpu_torch.bench.run_scale(n_reads, n_groups)`` on ``dev``
    with its artifacts under ``root``, launch counts set to 0 before it
    and read after it: its one JSON line (captured from stdout) must have
    bench.py's keys and name the card, every slice kernel must be
    launched, every read kept (filter counts) and aligned (mappings.bed),
    and each group outside the subtelomere mask one cluster of exactly
    its reads.  Returns the line with the launches, the peak device
    memory and the stages it rose in (the run's timings.json), the
    process's peak host RSS, the clustering path and sizes (query_graph's
    stats, from timings.json), the cluster counts and the rows of each
    read."""
    import io
    import resource

    from fslr_tpu_torch import bench
    from fslr_tpu_torch.tools.synth import REF_MB
    os.makedirs(root, exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line = bench.run_scale(n_reads, n_groups, dev, root=root)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    out = buf.getvalue().splitlines()
    if len(out) != 1 or json.loads(out[0]) != line:
        raise AssertionError(f'bench --scale: {len(out)} lines on stdout')
    _bench_line('scale', line, smi)
    for k in SLICE_PATH:
        if launches[k] <= 0:
            raise AssertionError(f'{k} was not launched by the scale run')
    base = os.path.join(root, 'out_scale', 'B')
    with open(base + '.timings.json') as fh:
        timings = json.load(fh)
    with open(base + '.filter_counts_summary.csv') as fh:
        head, vals = fh.read().splitlines()[1:3]
    counts = dict(zip(head.split(','), vals.split(',')))
    rows = rows_by_read(base + '.mappings.bed', n_reads)
    if int(counts['total_kept']) != n_reads or (rows == 0).any():
        raise AssertionError(f'{counts["total_kept"]} reads kept, '
                             f'{int((rows > 0).sum())} aligned, of {n_reads}')
    # tools.synth.make_dataset's contig length for n_groups
    ref_bp = max(REF_MB, 700_000 + n_groups * 1500 + 100_000)
    planted, members = planted_clusters(base, n_reads, n_groups, ref_bp)
    multi = sum(len(m) > 1 for m in members.values())
    graph = timings['query_graph']
    return dict(line, launches=launches, peak_device_bytes=peak,
                peak_rise_by_stage=timings['device_peak_rise_bytes'],
                peak_host_rss_bytes=rss, clustering_path=graph['path'],
                clustering_stats=graph, planted_clusters=len(planted),
                clusters_of_several=multi, clusters=len(members), rows=rows)


def start_cpu_baseline(root) -> subprocess.Popen:
    """Phase 13's CPU baseline, ``python -m fslr_tpu_torch.bench
    --cpu-baseline`` (1,000 reads, a warm-up and 3 runs on the host CPU),
    started in the background with BASELINE_THREADS torch threads, its
    output in ``root``; the cache is removed first (cpu_baseline_beside
    puts it back)."""
    from fslr_tpu_torch import bench
    if os.path.exists(bench.BASELINE_CACHE):
        os.remove(bench.BASELINE_CACHE)
    with open(os.path.join(root, 'cpu_baseline.out'), 'w') as out, \
            open(os.path.join(root, 'cpu_baseline.err'), 'w') as err:
        return subprocess.Popen(
            [sys.executable, '-m', 'fslr_tpu_torch.bench', '--cpu-baseline'],
            stdout=out, stderr=err, cwd=os.path.dirname(
                os.path.abspath(__file__)),
            env=dict(os.environ, OMP_NUM_THREADS=str(BASELINE_THREADS)))


@contextlib.contextmanager
def cpu_baseline_beside(root):
    """Phase 13's CPU baseline (start_cpu_baseline) in the background for
    the block, which gets (process, root, start) to hand to run_bench.
    When the block ends, pass or fail, the process is stopped and the
    bench's cache holds the bytes it held before, or is absent again: the
    baseline ran beside other phases, and no later bench run may read it
    as its own."""
    from fslr_tpu_torch import bench
    cache = bench.BASELINE_CACHE
    old = None
    if os.path.exists(cache):
        with open(cache, 'rb') as fh:
            old = fh.read()
    proc = None
    try:
        proc = start_cpu_baseline(root)
        yield proc, root, time.perf_counter()
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        if old is not None:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            with open(cache, 'wb') as fh:
                fh.write(old)
        elif os.path.exists(cache):
            os.remove(cache)


def cpu_baseline_done(proc, root, t_start) -> tuple:
    """Waits for :func:`start_cpu_baseline`'s process and caches its
    reads/s where the bench's default mode reads it, for phase 13's bench
    runs (cpu_baseline_beside puts the old cache back after them).
    Returns (reads/s, seconds it ran, seconds waited for it here)."""
    from fslr_tpu_torch import bench
    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    waited = time.perf_counter() - t0
    if rc:
        with open(os.path.join(root, 'cpu_baseline.err')) as fh:
            raise AssertionError(f'bench --cpu-baseline: rc {rc}\n'
                                 + fh.read()[-3000:])
    with open(os.path.join(root, 'cpu_baseline.out')) as fh:
        line = json.loads(fh.read().splitlines()[-1])
    os.makedirs(os.path.dirname(bench.BASELINE_CACHE), exist_ok=True)
    with open(bench.BASELINE_CACHE, 'w') as fh:
        json.dump(line, fh)
    return line['cpu_reads_per_s'], time.perf_counter() - t_start, waited


def run_bench(dev, root, smi, baseline) -> dict:
    """Phase 13: the bench as a user runs it, ``python -m
    fslr_tpu_torch.bench`` in a subprocess: ``--consensus --reads 2000``,
    then ``--scale 20000`` in this process (scale_run), both while the CPU
    baseline that ``baseline`` = (process, its root, its start) measures
    (:func:`start_cpu_baseline`) may still run; then the default mode
    (1,000 reads, then 10,000) against that baseline.  Each JSON line must
    have bench.py's keys and name the card.  Returns the --scale run's
    launches."""
    # the runs that need no CPU baseline go first, while it may still run
    cons, t_cons = _bench_process(
        ['--consensus', '--reads', str(BENCH_CONS_READS)], 'consensus', smi)
    if cons['profile_cells'] <= 0:
        raise AssertionError('bench --consensus counted no profile cells')
    groups = max(20, BENCH_SCALE_READS // 700)
    t0 = time.perf_counter()
    scale = scale_run(dev, os.path.join(root, 'bench_scale'),
                      BENCH_SCALE_READS, groups, smi)
    t_scale = time.perf_counter() - t0
    scale.pop('rows')
    base_rps, base_s, waited = cpu_baseline_done(*baseline)
    default, t_default = _bench_process([], 'default', smi)
    if not default['vs_baseline'] or default['vs_baseline'] <= 0:
        raise AssertionError(f'bench: vs_baseline {default["vs_baseline"]}')
    print('bench default: ' + json.dumps(default))
    print('bench consensus: ' + json.dumps(cons))
    print(json.dumps(dict(
        phase='bench', card=smi.splitlines()[0],
        cpu_baseline_reads_per_s=base_rps, cpu_baseline_s=base_s,
        cpu_baseline_threads=BASELINE_THREADS,
        cpu_baseline_waited_s=waited,
        cpu_baseline_beside_phases=list(BASELINE_BESIDE),
        default_s=t_default, consensus_s=t_cons, scale_s=t_scale,
        default_reads_per_s=default['value'],
        default_reads_per_s_10k=default['reads_per_s_10k'],
        vs_baseline=default['vs_baseline'],
        consensus_reads_per_s=cons['value'],
        **{f'scale_{k}': v for k, v in scale.items()})))
    return scale['launches']


def rows_of_template(dev, root, n_groups) -> np.ndarray:
    """mappings.bed rows a read of each of ``n_groups`` groups gives, from
    a BENCH_READS_10K-read run of tools.synth.make_dataset's template
    (--skip-clustering); the reads of a group are equal, so each must
    give the same rows."""
    os.makedirs(root)
    ref, fq = make_dataset(root, BENCH_READS_10K, n_groups)
    base = _run(root, ref, fq, 'template', dev, True)
    rows = rows_by_read(base + '.mappings.bed', BENCH_READS_10K)
    groups = np.arange(BENCH_READS_10K) % n_groups
    r_g = np.zeros(n_groups, np.int64)
    r_g[groups] = rows
    if not np.array_equal(r_g[groups], rows):
        raise AssertionError('reads of one group gave different rows')
    return r_g


@contextlib.contextmanager
def _kernel_ms(store: dict):
    """Adds to ``store`` the device milliseconds of each kernel's CUDA
    wrapper over the block's calls: CUDA events recorded around each call
    on the current stream, read once the block has ended, so that no
    launch waits for the card."""
    events = []

    def hook(name, fn, args, kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fn(*args, **kw)
        ev[1].record()
        events.append((name, ev))
        return out
    undo = _wrapped(list(KERNELS), hook)
    try:
        yield
    finally:
        undo()
        torch.cuda.synchronize()
        for name, (a, b) in events:
            store[name] = store.get(name, 0.0) + a.elapsed_time(b)


def host_memory() -> dict:
    """The host's total and available memory in bytes (/proc/meminfo)."""
    with open('/proc/meminfo') as fh:
        info = dict(line.split(':', 1) for line in fh)
    return {k: int(info[k].split()[0]) * 1024
            for k in ('MemTotal', 'MemAvailable')}


def main_scale(n: int, smi: str):
    """One-off, with ``--scale N``: the default pipeline at N reads in
    max(20, N // 700) groups (bench --scale N, scale_run), each read's
    mappings.bed rows held to a 10,000-read run of the same template;
    prints the line, the peak device memory and host RSS, the launches by
    kernel, the clustering path and the clusters."""
    dev = torch.device('cuda')
    print(f'scale {n}: host memory before the run '
          + json.dumps(host_memory()), flush=True)
    build_kernels()
    groups = max(20, n // 700)
    with tempfile.TemporaryDirectory(prefix='fslr_scale_') as root:
        r_g = rows_of_template(dev, os.path.join(root, 'template'), groups)
        t0 = time.perf_counter()
        kernel_ms: dict = {}
        with _kernel_ms(kernel_ms):
            res = scale_run(dev, os.path.join(root, 'scale'), n, groups,
                            smi)
        checks_s = time.perf_counter() - t0 - res['wall_s']
    rows = res.pop('rows')
    want = r_g[np.arange(n) % groups]
    if not np.array_equal(rows, want):
        raise AssertionError(f'mappings.bed: {int(rows.sum())} rows, '
                             f'{int(want.sum())} from the 10k run scaled')
    card = smi.splitlines()[0]
    print(f'scale {n}: peak device memory {res["peak_device_bytes"]} B '
          f'({card})')
    print(f'scale {n}: rise of the peak device memory by the stage at '
          'whose end it showed ' + json.dumps(res['peak_rise_by_stage']))
    print(f'scale {n}: peak host RSS {res["peak_host_rss_bytes"]} B')
    print(f'scale {n}: query_graph ' + json.dumps(res['clustering_stats']))
    print(f'scale {n}: launches ' + json.dumps(res['launches']))
    print(f'scale {n}: device ms of each kernel\'s own launches '
          + json.dumps(kernel_ms) + ', share of the wall '
          + json.dumps({k: v / 1e3 / res['wall_s']
                        for k, v in kernel_ms.items()}))
    print(f'scale {n}: FASTX parser {native.loaded_path()}')
    print(f'scale {n}: clustering path {res["clustering_path"]}, '
          f'{res["planted_clusters"]} planted clusters of {groups} groups '
          f'(the rest under the subtelomere mask), '
          f'{res["clusters_of_several"]} clusters of several reads, '
          f'{res["clusters"]} clusters; {int(rows.sum())} mappings.bed '
          f'rows == the 10k run scaled; checks {checks_s:.1f} s')
    print(json.dumps(dict(phase='scale', card=card, reads=n, groups=groups,
                          mappings_rows=int(rows.sum()),
                          kernel_ms=kernel_ms, **res)))


def _wrapped(names, hook):
    """Replace the CUDA wrappers of the kernels ``names`` by ones that call
    ``hook(name, wrapper, args, kw)`` in their place; returns a function
    that undoes the wrapping."""
    origs = []
    for name in names:
        mod, attr = WRAPPERS[name]
        orig = getattr(mod, attr)

        def wrapper(*args, _name=name, _orig=orig, **kw):
            return hook(_name, _orig, args, kw)
        setattr(mod, attr, wrapper)
        origs.append((mod, attr, orig))

    def undo():
        for mod, attr, orig in origs:
            setattr(mod, attr, orig)
    return undo


def _recorded(store, names):
    """Wrap the kernels ``names`` so that each launch's positional tensors
    are copied into ``store`` (name, args, keywords) before it runs."""
    def hook(name, fn, args, kw):
        store.append((name, tuple(a.clone() for a in args), kw))
        return fn(*args, **kw)
    return _wrapped(names, hook)


def _quartiles(x) -> list:
    x = x.float().cpu()
    return [int(v) for v in x.quantile(
        torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0])).tolist()] if x.numel() \
        else []


def _own_runs(root):
    """(run, root, (ref, fastq), consensus) of slice-10k and consensus-10k,
    their datasets made under ``root``."""
    runs = []
    for run, n_reads, n_groups, ref_bp, cons in (
            ('slice-10k', SLICE_READS, 20, SLICE_REF_BP, False),
            ('consensus-10k', CONS_READS, CONS_GROUPS, None, True)):
        rroot = os.path.join(root, run)
        os.makedirs(rroot)
        runs.append((run, rroot, make_dataset(rroot, n_reads, n_groups,
                                              ref_mb=ref_bp), cons))
    return runs


def own_launches(dev, path=None, reps: int = 3) -> dict:
    """Every kernel on the main path's own launches.

    Runs slice-10k (exact CIGARs) and consensus-10k through the CLI with
    every kernel's wrapper wrapped: each launch is also timed on its own
    inputs (CUDA events, ``reps`` calls after a warm-up), and with
    ``path`` the inputs of every launch of the ``SAVED`` kernels are saved
    there (on the host, ``torch.save``) for :func:`time_launches`.  Prints
    one JSON line per run and kernel (launches, total ms) and returns
    them."""
    totals, saved = {}, {}

    def hook(name, fn, args, kw):
        out = fn(*args, **kw)
        t = totals.setdefault((run, name), dict(launches=0, ms=0.0))
        t['launches'] += 1
        t['ms'] += _time_ms(lambda: fn(*args, **kw), reps)
        if path and name in SAVED:
            saved.setdefault(run, []).append(
                (name, tuple(a.cpu() for a in args), kw))
        return out

    with tempfile.TemporaryDirectory(prefix='fslr_own_') as root:
        for run, rroot, (ref, fq), cons in _own_runs(root):
            undo = _wrapped(WRAPPERS, hook)
            try:
                _run(rroot, ref, fq, run, dev, True, consensus=cons)
            finally:
                undo()
    for (run, name), t in totals.items():
        print('own launches ' + json.dumps(dict(run=run, kernel=name, **t)))
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save(saved, path)
    return totals


def launch_shape(name, args) -> dict:
    """Rows and width of a saved launch: for the SW kernels (q, t, ...,
    tlens) the rows, the target width T and the target-length quartiles
    (and the longest query for sw_kernel); for the traceback DPs (q, ...,
    qlens) the rows, the query width Lq and the qlen quartiles."""
    if name in SW_KERNELS:
        B, T = args[1].shape
        row = dict(rows=B, T=T, tlen_quartiles=_quartiles(args[-1]))
        if name == 'sw_kernel':
            row['qlen_max'] = int(args[2].max()) if B else 0
        return row
    N, Lq = args[0].shape
    return dict(rows=N, Lq=Lq, qlen_quartiles=_quartiles(args[-1]))


def longest_path(emits) -> int:
    """Steps of the longest walked path up to its last emitted op, from
    the 2-bit packed emits (N, T / 4) (3 = none): the walk's serial
    chain."""
    if not emits.numel():
        return 0
    codes = (emits.long()[:, :, None] >> torch.tensor(
        [0, 2, 4, 6], device=emits.device)) & 3
    codes = codes.reshape(emits.shape[0], -1)
    steps = torch.arange(1, codes.shape[1] + 1, device=emits.device)
    return int((steps * (codes != 3)).max())


def time_launches(path, dev, reps: int = 3):
    """Times sw_kernel, sw_packed_kernel, prof_kernel and walk_kernel on
    the launches :func:`own_launches` saved at ``path``, with the wrappers
    of the package first on ``sys.path`` (a parent tree's package times
    its own kernels on the same inputs).  The walk runs on the codes that
    this tree's tb and prof kernels make from their saved inputs (both
    DPs are exact, so every tree walks the same codes).  Prints one JSON
    line per launch (its shape as :func:`launch_shape`, the walk's
    longest path, ms) and one per run and kernel with the totals; returns
    the totals."""
    totals = {}

    def record(row):
        print('launch ' + json.dumps(row))
        t = totals.setdefault((row['run'], row['kernel']),
                              dict(launches=0, ms=0.0))
        t['launches'] += 1
        t['ms'] += row['ms']

    walk = getattr(*WRAPPERS['walk_kernel'])
    for run, launches in torch.load(path).items():
        for name, args, kw in launches:
            mod, attr = WRAPPERS[name]
            fn = getattr(mod, attr)
            args = [a.to(dev) for a in args]
            shape = launch_shape(name, args)
            if name != 'tb_kernel':
                record(dict(run=run, kernel=name, **shape,
                            ms=_time_ms(lambda: fn(*args, **kw), reps)))
            if name in ('tb_kernel', 'prof_kernel'):
                score, qend, lane, bits = fn(*args, **kw)
                _, emits = walk(bits, score, qend, lane)
                record(dict(run=run, kernel='walk_kernel', codes=name,
                            rows=shape['rows'], Lq=shape['Lq'],
                            longest_path=longest_path(emits),
                            ms=_time_ms(lambda: walk(bits, score, qend,
                                                     lane), reps)))
                del score, qend, lane, bits, emits
    for (run, name), t in totals.items():
        print('total ' + json.dumps(dict(run=run, kernel=name, **t)))
    return totals


def sweep_layouts(dev, reps: int = 3) -> list:
    """The banded DP kernels' two layouts on the main path's own launches.

    Runs slice-10k (exact CIGARs) and consensus-10k with the inputs of
    every banded and tb launch recorded, then runs each recorded launch in
    the kernel's narrow and wide layout, holds the wide result exactly to
    the narrow one, and times them in turns (narrow, wide, wide, narrow;
    CUDA events, ``reps`` calls after a warm-up).  Prints one JSON line
    per launch (rows, query width, qlen quartiles, steps, ms per layout,
    the wrapper's own pick) and one per run and kernel with the totals."""
    out = []
    with tempfile.TemporaryDirectory(prefix='fslr_layouts_') as root:
        for run, rroot, (ref, fq), cons in _own_runs(root):
            store = []
            undo = _recorded(store, DP_WRAPPERS)
            try:
                _run(rroot, ref, fq, run, dev, True, consensus=cons)
            finally:
                undo()
            totals = {}
            for name, args, kw in store:
                mod, attr, layouts = DP_WRAPPERS[name]
                fn = getattr(mod, attr)
                N, Lq = args[0].shape
                if not N:
                    continue
                _exact(f'{name} at {layouts[1]} columns a lane',
                       fn(*args, cpl=layouts[1], **kw),
                       fn(*args, cpl=layouts[0], **kw))
                ms = {c: [] for c in layouts}
                for c in layouts + layouts[::-1]:
                    ms[c].append(_time_ms(
                        lambda c=c: fn(*args, cpl=c, **kw), reps))
                ms = {str(c): float(np.mean(v)) for c, v in ms.items()}
                ql = args[2].float().quantile(
                    torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0], device=dev))
                row = dict(run=run, kernel=name, rows=N, width=Lq,
                           qlen_quartiles=[int(v) for v in ql.tolist()],
                           steps=int(args[2].clamp(max=Lq).sum()),
                           pick=banded._layout(N, dev, layouts), ms=ms)
                out.append(row)
                print('layouts ' + json.dumps(row))
                t = totals.setdefault(name, dict.fromkeys(
                    ('launches', *ms, 'pick', 'best'), 0))
                t['launches'] += 1
                for c, v in ms.items():
                    t[c] += v
                t['pick'] += ms[str(row['pick'])]
                t['best'] += min(ms.values())
            for name, t in totals.items():
                print('layouts total ' + json.dumps(dict(run=run, kernel=name,
                                                          **t)))
            del store
    return out


def _kernels_line(checks: dict, launches: dict, **by_card) -> dict:
    """The kernels JSON object: ``checks`` from check_kernels (its times
    and bound), ``launches`` the main run's counts; each of ``by_card``
    another run's counts, by kernel, under its own key."""
    return {'kernels': [
        dict(name=name, route='cuda', source=src, replaces=rep,
             launches=launches[name],
             **{k: v[name] for k, v in by_card.items()},
             max_abs_err=checks[name]['max_abs_err'],
             ms=checks[name]['ms'], plain_ms=checks[name]['plain_ms'],
             bound_ms=checks[name]['bound_ms'],
             bound_by=checks[name]['bound_by'], library_ms=None)
        for name, (src, rep) in KERNELS.items()]}


def main_cards(n: int, smi: str):
    """Phase 12 on the first ``n`` cards (n >= 2); raises on a host with
    fewer."""
    if n < 2:
        raise ValueError(f'--cards {n}: phase 12 needs at least 2 cards')
    if torch.cuda.device_count() < n:
        raise RuntimeError(f'--cards {n}: {torch.cuda.device_count()} '
                           'cards are visible')
    for line in smi.splitlines()[1:]:
        print(line)
    cards = [torch.device('cuda', i) for i in range(n)]
    build_kernels()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='fslr_cards_') as root:
        res = run_cards(cards, root)
    print(f'phase 12 on {n} cards: {time.perf_counter() - t0:.1f} s')
    checks = res['checks']
    first = dict(checks[0])
    for name in KERNELS:
        first[name] = dict(first[name], max_abs_err=max(
            c[name]['max_abs_err'] for c in checks.values()))
    print(json.dumps(_kernels_line(
        first, {k: sum(v.values()) for k, v in res['consensus'].items()},
        launches_cards=res['consensus'], launches_cards_slice=res['slice'],
        launches_cards_step=res['step'],
        launches_cards_processes=res['processes'],
        launches_cards_human_3g=res['human'])))


def main(argv=None):
    ap = argparse.ArgumentParser(description='Smoke test of fslr_tpu_torch '
                                 'on NVIDIA cards (see the module doc).')
    ap.add_argument('--cards', type=int, nargs='?', const=CARDS_DEFAULT,
                    help='run phase 12, the multi-card path, on this many '
                         f'cards instead of phases 3-13 on one (default '
                         f'{CARDS_DEFAULT}); raises on a host with fewer')
    ap.add_argument('--scale', type=int,
                    help='one-off: the default pipeline at this many reads '
                         '(bench --scale N) held to the planted truth, '
                         'instead of phases 3-13')
    opts = ap.parse_args(argv)
    smi = preflight()
    if opts.cards is not None:
        main_cards(opts.cards, smi)
    elif opts.scale is not None:
        main_scale(opts.scale, smi)
    else:
        main_one(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


@contextlib.contextmanager
def _phase(name: str, secs: dict):
    """Prints the seconds the block took, and keeps them in ``secs``."""
    t0 = time.perf_counter()
    yield
    secs[name] = time.perf_counter() - t0
    print(f'phase {name}: {secs[name]:.1f} s', flush=True)


def main_one(smi: str):
    """Phases 2-11 and 13 on one card."""
    dev = torch.device('cuda')
    secs: dict = {}
    with _phase('build', secs):
        build_kernels()
    with _phase('kernels', secs):
        checks = check_kernels(dev)
    with _phase('cluster-1m', secs):
        run_cluster_scale(dev, smi)
    with tempfile.TemporaryDirectory(prefix='fslr_smoke_') as root, \
            cross_cpu_beside(root) as cross_cpu:
        # phase 7's CPU halves go on in the background from here
        with _phase('slice', secs):
            slice_data = run_slice(dev, root)
        with _phase('fastx', secs):
            check_fastx(root, slice_data[1], smi)
        with _phase('index', secs):
            check_index(dev, *slice_data)
        with _phase('consensus', secs):
            launches, pileup = run_consensus(dev, root)
        with _phase('cross-check', secs):
            cross_check(dev, root, cross_cpu)
        # phase 13's CPU baseline runs on the host beside phases 10, 11, 8,
        # and human-3g's dataset is made beside phases 10 and 11
        base_root = os.path.join(root, 'cpu_baseline')
        os.makedirs(base_root)
        with cpu_baseline_beside(base_root) as baseline, \
                human_dataset_beside(root) as human_data:
            with _phase('parallel', secs):
                parallel = run_parallel(dev, root, *slice_data, smi)
            with _phase('step', secs):
                step = run_step(dev, *slice_data, smi)
            with _phase('human-3g', secs):
                human = run_human(dev, human_data)
            with _phase('bench', secs):
                bench_scale = run_bench(dev, root, smi, baseline)
    print('phase seconds: ' + json.dumps(secs))
    print(json.dumps(_kernels_line(
        checks, launches, launches_pileup=pileup, launches_human_3g=human,
        launches_mesh=parallel['mesh'],
        launches_two_processes=parallel['two_processes'],
        launches_step=step, launches_bench_scale_20k=bench_scale)))


if __name__ == '__main__':
    main()
