#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fslr_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is then not 0):

1. preflight: a CUDA card must be present; prints nvidia-smi's name and
   power limit;
2. build: nvcc compiles fslr_tpu_torch/csrc/*.cu for sm_90a;
3. kernel checks: every kernel of the slice against its plain PyTorch
   version on the card, at the main path's shapes, from seeded inputs --
   the DP kernels and the traceback walk must match exactly (tb codes in
   the words that hold a row's query steps; the kernel zeroes the rest),
   the repeat mask may differ in at most 1 decision in 10^6 and only
   where the plain posterior lies within 1e-4 of the threshold; both
   times are printed;
4. slice: ``fslr_tpu_torch.cli.main`` (exact CIGARs, the default) on
   10,000 synthetic 2.7 kb fusion amplicons against a 2 x 50 Mbp random
   reference (bench.make_dataset); every kernel's launch counter must be
   > 0, the artifacts must exist, the planted chrB segment must be found
   in >= 99% of the reads, every primary's CIGAR must span its sequence
   (M + I + S) and a seeded sample of 1,000 records must have an AS tag
   equal to the score replayed from its CIGAR against the reference.
   Then the earlier path, run_pipeline with exact_cigars=False, on the
   same data (index cache warm): its four kernels must be launched, the
   traceback kernels not, and recall must hold;
5. cross-check: 200 reads on the default 2 x 2 Mbp reference run on the
   card and on the CPU, with exact CIGARs (through the CLI) and without;
   mappings.bed, filter_counts_summary.csv and the BAM's records must be
   byte-equal.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
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

from fslr_tpu.config import JunkFilterConfig, PipelineConfig, ScoringConfig
from fslr_tpu_torch import kernels
from fslr_tpu_torch.ops import banded, ssw, tantan, traceback

SLICE_READS = 10_000
SLICE_REF_BP = 50_000_000           # per contig, 2 contigs
CROSS_READS = 200
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
}
EARLIER_PATH = ('mask_kernel', 'sw_packed_kernel', 'sw_kernel',
                'banded_kernel')


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
    out['sw_kernel'] = dict(
        max_abs_err=_exact('sw_kernel', got, want),
        ms=_time_ms(lambda: ssw._sw_cuda(*args, **kw), 10),
        plain_ms=_time_ms(lambda: ssw._sw_torch(*args, **kw), 1))

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
    out['sw_packed_kernel'] = dict(
        max_abs_err=_exact('sw_packed_kernel', got, want),
        ms=_time_ms(lambda: ssw._sw_packed_cuda(*args, stride=32, **kw), 3),
        plain_ms=_time_ms(
            lambda: ssw._sw_packed_torch(*args, stride=32, **kw), 1))

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
        plain_ms=_time_ms(lambda: banded._banded_torch(*args, **kw), 1))

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
        plain_ms=_time_ms(lambda: traceback._tb_torch(*args, **kw), 1))
    score, qend, lane, bits = got
    T = Lq + banded.BW

    def walk_plain():
        return traceback._pack_walk(score, qend, lane, *traceback._walk_torch(
            want[3], qend, lane, T))

    out['walk_kernel'] = dict(
        max_abs_err=_exact('walk_kernel', traceback._walk_cuda(
            bits, score, qend, lane), walk_plain()),
        ms=_time_ms(lambda: traceback._walk_cuda(bits, score, qend, lane),
                    3),
        plain_ms=_time_ms(walk_plain, 1))
    del bits, got, want

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
        plain_ms=_time_ms(lambda: tantan._posterior_torch(st, cfg), 1))
    for name, r in out.items():
        print(f'kernel {name}: ' + ', '.join(f'{k}={v}'
                                             for k, v in r.items()))
    return out


def _run(root, ref, fq, tag, dev, exact):
    """One slice run: through the CLI with exact CIGARs (its default),
    through run_pipeline without."""
    out = os.path.join(root, f'out_{tag}')
    if exact:
        from fslr_tpu_torch.cli import main
        main(['--name', 'S', '--out', out, '--ref', ref, '--primers',
              '21q1,17p6', '--basecalled', fq, '--skip-clustering',
              '--device', str(dev)])
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
    span = max(1, min(40_000, (SLICE_REF_BP - 700_000) // 20))
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
    from fslr_tpu.encode import encode, revcomp_str
    from fslr_tpu.index.reference import load_reference
    from fslr_tpu.io.bam import read_bam
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


def run_slice(dev, root) -> dict:
    """The main path at full width through the CLI (exact CIGARs): 10k
    reads, 2 x 50 Mbp reference; then the earlier path (exact_cigars=False)
    on the same data."""
    import bench
    t0 = time.perf_counter()
    ref, fq = bench.make_dataset(root, SLICE_READS, 20, ref_mb=SLICE_REF_BP)
    t_data = time.perf_counter() - t0
    results = {}
    for exact in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        base = _run(root, ref, fq, f'slice_{exact}', dev, exact)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = KERNELS if exact else EARLIER_PATH
        for k in want:
            if launches[k] <= 0:
                raise AssertionError(f'{k} was not launched by the path '
                                     f'(exact_cigars={exact})')
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
        with open(base + '.timings.json') as fh:
            stages = json.load(fh)['timings_s']
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
        results[exact] = launches
    return results[True]


def cross_check(dev, root):
    """200 reads on the card and on the CPU, with and without exact
    CIGARs: artifacts byte-equal."""
    import bench
    root = os.path.join(root, 'cross')
    os.makedirs(root)
    ref, fq = bench.make_dataset(root, CROSS_READS)
    for exact in (True, False):
        base_g = _run(root, ref, fq, f'card_{exact}', dev, exact)
        base_c = _run(root, ref, fq, f'cpu_{exact}', torch.device('cpu'),
                      exact)
        for suffix in ('.mappings.bed', '.filter_counts_summary.csv'):
            with open(base_g + suffix, 'rb') as a, \
                    open(base_c + suffix, 'rb') as b:
                if a.read() != b.read():
                    raise AssertionError(f'{suffix}: card and CPU runs '
                                         f'differ (exact_cigars={exact})')
        with open(base_g + '.bwa_dodi.bam', 'rb') as a, \
                open(base_c + '.bwa_dodi.bam', 'rb') as b:
            if gzip.decompress(a.read()) != gzip.decompress(b.read()):
                raise AssertionError(f'BAM records: card and CPU runs '
                                     f'differ (exact_cigars={exact})')
        n_rows = len(_read_bed(base_g + '.mappings.bed'))
        print(f'cross-check (exact_cigars={exact}): {CROSS_READS} reads, '
              f'card == CPU for mappings.bed ({n_rows} rows), '
              f'filter_counts_summary.csv and BAM records')


def main():
    preflight()
    dev = torch.device('cuda')
    build_kernels()
    checks = check_kernels(dev)
    with tempfile.TemporaryDirectory(prefix='fslr_smoke_') as root:
        launches = run_slice(dev, root)
        cross_check(dev, root)
    print(json.dumps({'kernels': [
        dict(name=name, route='cuda', source=src, replaces=rep,
             launches=launches[name], max_abs_err=checks[name]['max_abs_err'],
             ms=checks[name]['ms'], plain_ms=checks[name]['plain_ms'])
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
