#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fslr_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is then not 0):

1. preflight: a CUDA card must be present; prints nvidia-smi's name and
   power limit;
2. build: nvcc compiles fslr_tpu_torch/csrc/*.cu for sm_90a;
3. kernel checks: every kernel against its plain PyTorch version on the
   card, at the main path's shapes, from seeded inputs -- the DP kernels
   and the traceback walk must match exactly (tb and profile codes in the
   words that hold a row's query steps; the kernels zero the rest), the
   repeat mask may differ in at most 1 decision in 10^6 and only where
   the plain posterior lies within 1e-4 of the threshold; both times are
   printed, with each kernel's bound (the least time the card could take
   for the same work);
4. slice: ``fslr_tpu_torch.cli.main`` (exact CIGARs, the default,
   ``--skip-clustering``) on 10,000 synthetic 2.7 kb fusion amplicons
   against a 2 x 50 Mbp random reference (fslr_tpu_torch.tools.synth);
   its six kernels must be launched, the artifacts must exist, the
   planted chrB segment must be found in >= 99% of the reads, every
   primary's CIGAR must span its sequence (M + I + S) and a seeded sample
   of 1,000 records must have an AS tag equal to the score replayed from
   its CIGAR against the reference.  Then the earlier path, run_pipeline
   with exact_cigars=False, on the same data (index cache warm): its four
   kernels must be launched, the traceback kernels not, and recall must
   hold;
5. consensus: the CLI's default run (clustering) with ``--consensus`` on
   the repo's consensus configuration, 10,000 reads in 500 breakpoint
   groups of 20 on the default 2 x 2 Mbp reference; all seven kernels
   must be launched; every planted group outside the subtelomere mask
   (500 kb from a chromosome end) must be one cluster of its 20 reads,
   the masked groups' reads singletons; each such cluster's consensus
   must equal its members' sequence, and the merged bed and BAM exist;
6. cross-check: 200 reads on the default 2 x 2 Mbp reference run on the
   card and on the CPU, with exact CIGARs (through the CLI) and without,
   and 200 reads in 10 groups with clustering and --consensus; every
   artifact (beds, FASTAs, purity CSV, filter counts) must be byte-equal
   and the BAMs' records equal.

The line before the last is a JSON object with each kernel's launches on
the consensus run, error, times and bound; the last line is
{"ok": true, "device": {...}}.
"""

import csv
import gzip
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from fslr_tpu_torch import kernels
from fslr_tpu_torch.config import (JunkFilterConfig, PipelineConfig,
                                   ScoringConfig)
from fslr_tpu_torch.ops import (banded, poa, profile_align, ssw, tantan,
                                traceback)
from fslr_tpu_torch.tools.synth import group_span, make_dataset

SLICE_READS = 10_000
SLICE_REF_BP = 50_000_000           # per contig, 2 contigs
CONS_READS, CONS_GROUPS = 10_000, 500     # the consensus configuration
CONS_REF_BP = 2_000_000                   # its default reference
SUBTELOMERE = 500_000
CROSS_READS = 200
CROSS_GROUPS = 10
AS_SAMPLE = 1_000
CLIPS_ONLY_MAX = 0.02   # share of records with no M/I/D (500 of 44,500 in phase 4)

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

# The least time the card could take: the larger of operations over the
# float32 CUDA-core peak and bytes (inputs read once, outputs written
# once) over the HBM rate (NVIDIA H100 SXM data sheet, at 700 W).
PEAK_F32 = 67e12
PEAK_HBM = 3.35e12
# operations per DP cell (per state and position for the mask, per path
# step for the walk), counted from each kernel's step: the score or its
# extraction, E, H, the lazy-F prefix max (in-thread max plus the shuffle
# scan's share), F, the best update, and the traceback code where there
# is one
OPS_PER_CELL = {'sw_kernel': 24, 'sw_packed_kernel': 27, 'banded_kernel': 23,
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


def check_kernels(dev) -> dict:
    """Each kernel vs its plain version on the card; returns per-kernel
    {max_abs_err, ms, plain_ms}."""
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
    steps = int(np.minimum(tlens, T).sum())
    out['sw_kernel'] = dict(
        max_abs_err=_exact('sw_kernel', got, want),
        ms=_time_ms(lambda: ssw._sw_cuda(*args, **kw), 10),
        plain_ms=_time_ms(lambda: ssw._sw_torch(*args, **kw), 1),
        **_bound('sw_kernel', steps * ssw.QP,
                 B * ssw.QP + steps + 8 * B + 12 * B))

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
    steps = int(np.minimum(tlens, T).sum())
    out['sw_packed_kernel'] = dict(
        max_abs_err=_exact('sw_packed_kernel', got, want),
        ms=_time_ms(lambda: ssw._sw_packed_cuda(*args, stride=32, **kw), 3),
        plain_ms=_time_ms(
            lambda: ssw._sw_packed_torch(*args, stride=32, **kw), 1),
        **_bound('sw_packed_kernel', steps * ssw.QP,
                 B * ssw.QP + steps + 4 * B + 12 * B))

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
    got = banded._banded_cuda(*args, **kw)
    want = banded._banded_torch(*args, **kw)
    out['banded_kernel'] = dict(
        max_abs_err=_exact('banded_kernel', got, want),
        ms=_time_ms(lambda: banded._banded_cuda(*args, **kw), 3),
        plain_ms=_time_ms(lambda: banded._banded_torch(*args, **kw), 1),
        **_bound('banded_kernel', *_dp_work(args[2].cpu(), Lq, lambda n: n,
                                            1, 12 * N)))

    # tb_kernel and walk_kernel: 1024 selected alignments x 3072-base
    # slices (the banded inputs above; row 0 scores nothing)
    N = 1024
    q[0] = 4
    args = [torch.from_numpy(a[:N]).to(dev) for a in (q, w, qlens)]
    got = traceback._tb_cuda(*args, **kw)
    want = traceback._tb_torch(*args, **kw)
    err = _exact('tb_kernel', got[:3], want[:3])
    live = (torch.arange(Lq // 8, device=dev)[None, :]
            < ((args[2].long() + 7) // 8)[:, None])
    err = max(err, _exact('tb_kernel bits', [got[3][live]], [want[3][live]]))
    if got[3][~live].any():
        raise AssertionError('tb_kernel: words past a row end are not 0')
    out['tb_kernel'] = dict(
        max_abs_err=err,
        ms=_time_ms(lambda: traceback._tb_cuda(*args, **kw), 3),
        plain_ms=_time_ms(lambda: traceback._tb_torch(*args, **kw), 1),
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
        ms=_time_ms(lambda: traceback._walk_cuda(bits, score, qend, lane),
                    3),
        plain_ms=_time_ms(walk_plain, 1),
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
    err = _exact('prof_kernel', got[:3], want[:3])
    live = (torch.arange(Lq // 8, device=dev)[None, :]
            < ((args[3].long() + 7) // 8)[:, None])
    err = max(err, _exact('prof_kernel bits', [got[3][live]],
                          [want[3][live]]))
    if got[3][~live].any():
        raise AssertionError('prof_kernel: words past a row end are not 0')
    if float(want[0][0]) != 0.0 or not bool((want[0][1:] > 0).all()):
        raise AssertionError('prof_kernel: unexpected row scores')
    out['prof_kernel'] = dict(
        max_abs_err=err,
        ms=_time_ms(lambda: profile_align._prof_cuda(*args, **kw), 3),
        plain_ms=_time_ms(lambda: profile_align._prof_torch(*args, **kw), 1),
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
        ms=_time_ms(lambda: traceback._walk_cuda(bits, score, qend, lane),
                    3), **_bound('walk_kernel', *_walk_work(walked[0].cpu(),
                                                             T)))
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
    out['mask_kernel'] = dict(
        max_abs_err=float((got - want).abs().max()),
        decisions_differing=n_diff, masked=int((want >= thr).sum()),
        ms=_time_ms(lambda: tantan._posterior_cuda(st, cfg), 3),
        plain_ms=_time_ms(lambda: tantan._posterior_torch(st, cfg), 1),
        **_bound('mask_kernel', B * L * (cfg.mask_max_period + 1),
                 B * L * 5))
    for name, r in out.items():
        print(f'kernel {name}: ' + ', '.join(f'{k}={v}'
                                             for k, v in r.items()))
    return out


def _run(root, ref, fq, tag, dev, exact, consensus=False):
    """One run: through the CLI with exact CIGARs (its default; clustering
    and consensus with ``consensus``, else --skip-clustering), through
    run_pipeline without."""
    out = os.path.join(root, f'out_{tag}')
    if exact:
        from fslr_tpu_torch.cli import main
        main(['--name', 'S', '--out', out, '--ref', ref, '--primers',
              '21q1,17p6', '--basecalled', fq, '--device', str(dev)]
             + (['--consensus'] if consensus else ['--skip-clustering']))
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


def _recall(rows) -> float:
    """Share of reads whose planted chrB segment is in mappings.bed: read
    r{i} carries chrB[600_000 + (i % 20) * span ...]."""
    span = group_span(SLICE_REF_BP, 20)
    found = set()
    for r in rows:
        i = int(r['qname'].split('.')[0][1:])
        bpos = 600_000 + (i % 20) * span
        if r['chrom'] == 'chrB' and abs(int(r['rstart']) - 1 - bpos) <= 50:
            found.add(i)
    return len(found) / SLICE_READS


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


def check_bam(base, ref_path) -> dict:
    """Every primary's CIGAR spans its sequence; sampled AS tags equal
    their CIGAR replays against the reference.

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
    for k in pick.tolist():
        r = recs[k]
        p = primary[r.qname]
        seq = p.seq if p.is_reverse == r.is_reverse else revcomp_str(p.seq)
        if r.infer_read_length() != len(seq):
            raise AssertionError(f'{r.qname}: CIGAR read length '
                                 f'{r.infer_read_length()} != {len(seq)}')
        got = _replay(r.cigar, encode(seq), contigs[r.ref_id], r.pos, sc)
        if got != r.tags['AS']:
            raise AssertionError(f'{r.qname} at {r.ref_id}:{r.pos}: AS '
                                 f'{r.tags["AS"]} != replayed {got}')
    n_indel = sum(any(op in 'ID' for _, op in r.cigar) for r in recs)
    return dict(records=len(recs), primaries=len(primary),
                as_replayed=len(pick), no_core_ops=len(recs) - len(core),
                with_indels=n_indel)


def _run_measured(root, ref, fq, tag, dev, exact, want, consensus=False):
    """A run with launch counts set to 0 before it and read after it;
    each kernel of ``want`` must have been launched."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    base = _run(root, ref, fq, tag, dev, exact, consensus)
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
        recall = _recall(rows)
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


def _read_fasta(path):
    with open(path) as fh:
        lines = fh.read().split()
    return dict(zip((h[1:] for h in lines[0::2]), lines[1::2]))


def check_clusters(base, n_reads, n_groups, ref_bp):
    """Each planted group outside the subtelomere mask (read r{i} is in
    group i % n_groups) is one cluster of exactly its reads, and that
    cluster's consensus equals the members' sequence.  Reads of masked
    groups stay singletons unless another shared interval links them: a
    spurious short alignment in the primer makes the chrA segment a
    filling, and such reads of several masked groups cluster together, as
    in fslr_tpu.  Returns (planted clusters, all clusters)."""
    span = group_span(ref_bp, n_groups)
    kept = {g for g in range(n_groups)
            if 600_000 + g * span + 1000 <= ref_bp - SUBTELOMERE}
    size = n_reads // n_groups
    members: dict = {}
    for r in _read_bed(base + '.mappings.cluster.bed'):
        cl = int(float(r['cluster']))
        members.setdefault(cl, set()).add(int(r['qname'].split('.')[0][1:]))
    by_group: dict = {}
    for cl, reads in members.items():
        for i in reads:
            by_group.setdefault(i % n_groups, set()).add(cl)
    planted = {}
    for g in sorted(kept):
        cls = by_group.get(g, set())
        cl = min(cls) if cls else None
        if len(cls) != 1 or len(members[cl]) != size or \
                {i % n_groups for i in members[cl]} != {g}:
            raise AssertionError(f'group {g} is not one cluster of its '
                                 f'{size} reads')
        planted[cl] = g
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


def run_consensus(dev, root) -> dict:
    """This slice's main path: the CLI's default run (clustering) with
    --consensus on the repo's consensus configuration.  Returns its
    launch counts."""
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
    return launches


def _same(a, b, what):
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
        da, db = fa.read(), fb.read()
    if a.endswith('.bam'):
        da, db = gzip.decompress(da), gzip.decompress(db)
    if da != db:
        raise AssertionError(f'{what}: card and CPU runs differ')


def cross_check(dev, root):
    """200 reads on the card and on the CPU, with and without exact
    CIGARs, and with clustering and consensus: artifacts byte-equal."""
    root = os.path.join(root, 'cross')
    os.makedirs(root)
    ref, fq = make_dataset(root, CROSS_READS)
    for exact in (True, False):
        base_g = _run(root, ref, fq, f'card_{exact}', dev, exact)
        base_c = _run(root, ref, fq, f'cpu_{exact}', torch.device('cpu'),
                      exact)
        for suffix in ('.mappings.bed', '.filter_counts_summary.csv',
                       '.bwa_dodi.bam'):
            _same(base_g + suffix, base_c + suffix,
                  f'{suffix} (exact_cigars={exact})')
        n_rows = len(_read_bed(base_g + '.mappings.bed'))
        print(f'cross-check (exact_cigars={exact}): {CROSS_READS} reads, '
              f'card == CPU for mappings.bed ({n_rows} rows), '
              f'filter_counts_summary.csv and BAM records')
    root = os.path.join(root, 'consensus')
    os.makedirs(root)
    ref, fq = make_dataset(root, CROSS_READS, CROSS_GROUPS)
    bases = [_run(root, ref, fq, tag, d, True, consensus=True)
             for tag, d in (('card', dev), ('cpu', torch.device('cpu')))]
    files = []
    for dirpath, _, names in os.walk(os.path.dirname(bases[0])):
        rel = os.path.relpath(dirpath, os.path.dirname(bases[0]))
        files += [os.path.join(rel, n) for n in names
                  if not n.endswith(('.timings.json', '.no_primers.fq'))]
    for rel in sorted(files):
        a = os.path.join(os.path.dirname(bases[0]), rel)
        _same(a, os.path.join(os.path.dirname(bases[1]), rel), rel)
    _, n = check_clusters(bases[0], CROSS_READS, CROSS_GROUPS, CONS_REF_BP)
    print(f'cross-check (consensus): {CROSS_READS} reads in {n} clusters, '
          f'card == CPU for {len(files)} artifacts (beds, FASTAs, purity '
          f'CSV, BAM records)')


def main():
    preflight()
    dev = torch.device('cuda')
    build_kernels()
    checks = check_kernels(dev)
    with tempfile.TemporaryDirectory(prefix='fslr_smoke_') as root:
        run_slice(dev, root)
        launches = run_consensus(dev, root)
        cross_check(dev, root)
    print(json.dumps({'kernels': [
        dict(name=name, route='cuda', source=src, replaces=rep,
             launches=launches[name], max_abs_err=checks[name]['max_abs_err'],
             ms=checks[name]['ms'], plain_ms=checks[name]['plain_ms'],
             bound_ms=checks[name]['bound_ms'],
             bound_by=checks[name]['bound_by'], library_ms=None)
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
