#!/usr/bin/env python3
"""Time two trees of this repository on one CUDA card, in turns: the
slice-10k runs of chip_smoke.py's phase 4 (exact CIGARs through the CLI,
index built on the card, then ``exact_cigars=False`` with the index cache
warm) and its phase-6 consensus-10k run, each tree's own code and its own
``chip_smoke.py`` helpers.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [--order PCCP] [--out FILE]
    python3 chip_ab.py PARENT_DIR CHANGE_DIR --scale N [--order PCCP]

With ``--scale N`` each run is instead ``python3 chip_smoke.py --scale N``
in the tree (the default pipeline at N reads held to the planted truth):
it compares each run's wall seconds and its stage seconds, and the runs'
mappings.bed rows and clusters must be equal.

Each run is a fresh process in the tree's directory, so every one pays
the same start-up; the data are made anew (seeded, untimed) in each.  The
runs' artifacts (beds, the BAM and its index, counts) must be byte-equal
across all runs, or the script exits with 1.  It prints each run's wall
seconds, the card's name and power limit, and, as its last line, a
JSON summary; ``--out`` gets it with every run's stage times and
launches.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_RUN = r'''
import hashlib, json, os, sys, tempfile
import torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs

def digest(base, suffixes):
    out = {}
    for s in suffixes:
        with open(base + s, 'rb') as fh:
            out[s] = hashlib.sha256(fh.read()).hexdigest()
    return out

dev = torch.device('cuda')
cs.build_kernels()
res = {}
with tempfile.TemporaryDirectory(prefix='fslr_ab_') as root:
    ref, fq = cs.make_dataset(root, cs.SLICE_READS, 20,
                              ref_mb=cs.SLICE_REF_BP)
    for exact in (True, False):
        base, wall, launches, peak, stages = cs._run_measured(
            root, ref, fq, f'slice_{exact}', dev, exact,
            cs.SLICE_PATH if exact else cs.EARLIER_PATH)
        res[f'slice_exact_{exact}'] = dict(
            wall_s=wall, stages=stages, launches=launches,
            sha256=digest(base, ('.mappings.bed', '.bwa_dodi.bam',
                                 '.bwa_dodi.bam.bai',
                                 '.filter_counts_summary.csv')))
    croot = os.path.join(root, 'consensus')
    os.makedirs(croot)
    cref, cfq = cs.make_dataset(croot, cs.CONS_READS, cs.CONS_GROUPS)
    base, wall, launches, peak, stages = cs._run_measured(
        croot, cref, cfq, 'consensus', dev, True, cs.KERNELS,
        consensus=True)
    res['consensus'] = dict(
        wall_s=wall, stages=stages, launches=launches,
        sha256=digest(base, ('.mappings.bed', '.mappings.cluster.bed',
                             '.mappings.representative.bed',
                             '.bwa_dodi.bam', '.filter_counts_summary.csv')))
print('AB ' + json.dumps(res))
'''


def _smi() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip()


def _one(tree: str, timeout: int) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    p = subprocess.run([sys.executable, '-c', _RUN], cwd=tree, env=env,
                       capture_output=True, text=True, timeout=timeout)
    if p.returncode:
        sys.stderr.write(p.stdout[-4000:] + p.stderr[-8000:])
        raise SystemExit(f'{tree}: exit code {p.returncode}')
    line = [ln for ln in p.stdout.splitlines() if ln.startswith('AB ')][-1]
    return json.loads(line[3:])


SCALE_STAGES = ('filter_junk', 'find_primers')   # compared with --scale


def _one_scale(tree: str, n: int, timeout: int) -> dict:
    """``python3 chip_smoke.py --scale n`` in ``tree``: its scale line's
    wall and stage seconds, reads/s, rows and clusters, the FASTX parser
    line where the tree prints one, and the process's seconds."""
    env = dict(os.environ, PYTHONPATH=tree)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, 'chip_smoke.py', '--scale', str(n)],
                       cwd=tree, env=env, capture_output=True, text=True,
                       timeout=timeout)
    secs = time.perf_counter() - t0
    if p.returncode:
        sys.stderr.write(p.stdout[-4000:] + p.stderr[-8000:])
        raise SystemExit(f'{tree}: exit code {p.returncode}')
    out = p.stdout.splitlines()
    line = [json.loads(ln) for ln in out
            if ln.startswith('{"phase": "scale"')][-1]
    return dict(process_s=secs, wall_s=line['wall_s'],
                stage_s=line['stage_s'], reads_per_s=line['value'],
                mappings_rows=line['mappings_rows'],
                clusters=line['clusters'],
                parser=[ln for ln in out if 'FASTX parser' in ln])


def main_scale(args, trees, smi):
    runs = []
    for tag in args.order:
        r = _one_scale(trees[tag], args.scale, args.timeout)
        runs.append(dict(tree=tag, **r))
        print(tag + ' ' + json.dumps(dict(
            wall_s=r['wall_s'], process_s=round(r['process_s'], 1),
            **{k: r['stage_s'].get(k) for k in SCALE_STAGES})), flush=True)
    differ = [k for k in ('mappings_rows', 'clusters')
              if len({r[k] for r in runs}) > 1]
    times = {k: {t: [r['wall_s'] if k == 'wall_s' else r['stage_s'][k]
                     for r in runs if r['tree'] == t] for t in trees}
             for k in ('wall_s',) + SCALE_STAGES}
    summary = dict(card=smi, order=args.order, reads=args.scale,
                   artifacts_differ=differ, seconds=times, runs=runs)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps(dict(card=smi, order=args.order, reads=args.scale,
                          artifacts_differ=differ, seconds=times)))
    if differ:
        raise SystemExit(f'the runs differ in {differ}')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('parent')
    ap.add_argument('change')
    ap.add_argument('--order', default='PCCP')
    ap.add_argument('--timeout', type=int, default=600,
                    help='seconds a run may take')
    ap.add_argument('--out', default=None)
    ap.add_argument('--scale', type=int,
                    help='run chip_smoke.py --scale N in each tree instead')
    args = ap.parse_args()
    smi = _smi()
    print(smi)
    trees = {'P': os.path.abspath(args.parent),
             'C': os.path.abspath(args.change)}
    if args.scale:
        return main_scale(args, trees, smi)
    runs = []
    for tag in args.order:
        r = _one(trees[tag], args.timeout)
        runs.append(dict(tree=tag, **r))
        print(tag + ' ' + json.dumps({k: round(v['wall_s'], 3)
                                      for k, v in r.items()}), flush=True)
    keys = ('slice_exact_True', 'slice_exact_False', 'consensus')
    differ = sorted({k + s for r in runs for k in keys
                     for s, h in r[k]['sha256'].items()
                     if h != runs[0][k]['sha256'][s]})
    walls = {k: {t: [r[k]['wall_s'] for r in runs if r['tree'] == t]
                 for t in trees} for k in keys}
    summary = dict(card=smi, order=args.order, artifacts_differ=differ,
                   wall_s=walls, runs=runs)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps(dict(card=smi, order=args.order,
                          artifacts_differ=differ, wall_s=walls)))
    if differ:
        raise SystemExit(f'the runs differ in {differ}')


if __name__ == '__main__':
    main()
