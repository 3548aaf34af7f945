"""Readings of the comparison that decides ``correct``, on the program as
the configuration states it, on the control and on planted faults.

    python3 -m benchmark.control --workload NAME --seeds S1,S2,... \
        --seconds S [--control | --fault NAME] [--mix '{"key": value}']

runs the cell once a seed in one process, as ``benchmark.run`` does with
``--trace 0`` (set-up without the warm-up, window, the comparison), and
prints one JSON line a seed with every compared number.  ``--mix``
changes keys of the cell's mix for a trial (a stand-in's traffic); the
benchmark's own runs never run this module.

* the control, ``approx_cigars`` (the configuration names it under
  ``"control"``): the program's own approximate-CIGAR path
  (``exact_cigars=False``: clips, one M run and the reference-span indel
  in place of the traceback's CIGARs), the step below exact CIGARs;
* ``half_batch``: the pipeline reads every other input file;
* ``score_plus_one``: every alignment's score + 1 where align produces it.

For ``tf2p_recluster`` (an earlier run's mappings clustered anew):

* the control, ``overlap_half``: the clustering's reciprocal overlap at
  0.5 in place of the 0.8 the configuration states (the guarantee that
  keeps breakpoints beside each other apart);
* ``half_rows``: the clustering reads every other read of the mappings;
* ``lowest_representative``: each cluster's representative is its read
  of the lowest mean score, where the clustering chooses it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def approx_cigars(config):
    return config.replace(exact_cigars=False)


def overlap_half(config):
    return config.replace(cluster=dataclasses.replace(config.cluster,
                                                      overlap=0.5))


CONTROLS = {'approx_cigars': approx_cigars, 'overlap_half': overlap_half}


def half_batch(patch):
    from fslr_tpu_torch import pipeline
    whole = pipeline.glob_input_files
    patch(pipeline, 'glob_input_files', lambda folder: whole(folder)[::2])


def score_plus_one(patch):
    import numpy as np

    from fslr_tpu_torch.stages import align
    aligned = align.align_batch

    def altered(*a, **k):
        aln = aligned(*a, **k)
        aln.score[:] = np.asarray(aln.score) + 1
        return aln
    patch(align, 'align_batch', altered)


def half_rows(patch):
    from fslr_tpu_torch.stages import cluster
    whole = cluster.read_mappings

    def half(*a, **k):
        bed = whole(*a, **k)
        _, read = np.unique(bed['qname'], return_inverse=True)
        keep = read % 2 == 0
        return {c: v[keep] for c, v in bed.items()}
    patch(cluster, 'read_mappings', half)


def lowest_representative(patch):
    from fslr_tpu_torch.stages import cluster
    chosen = cluster.choose_alignment

    def lowest(bed):
        flipped = dict(bed)
        flipped['alignment_score'] = -bed['alignment_score']
        out = chosen(flipped)
        out['alignment_score'] = -out['alignment_score']
        return out
    patch(cluster, 'choose_alignment', lowest)


FAULTS = {'half_batch': half_batch, 'score_plus_one': score_plus_one,
          'half_rows': half_rows,
          'lowest_representative': lowest_representative}


def main(argv=None) -> int:
    from benchmark import run
    ap = argparse.ArgumentParser(prog='python3 -m benchmark.control')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', required=True, type=float)
    ap.add_argument('--control', action='store_true')
    ap.add_argument('--fault', choices=sorted(FAULTS))
    ap.add_argument('--mix', default='{}')
    args = ap.parse_args(argv)
    cell, config, mix, e2e, layer = run.load_cell(args.workload)
    mix.update(json.loads(args.mix))
    run._env()
    import torch
    if not torch.cuda.is_available():
        print('benchmark.control: needs a CUDA card', file=sys.stderr)
        return 2
    alter = CONTROLS[config['control']] if args.control else None
    if args.fault:
        FAULTS[args.fault](setattr)
    for seed in (int(s) for s in args.seeds.split(',')):
        t = time.perf_counter()
        result, lines, where = run.run_cell(
            config, mix, e2e, [], seed, args.seconds, False,
            torch.device('cuda', 0), alter=alter, t0=t, warm=False)
        print('\n'.join(lines), file=sys.stderr)
        print(json.dumps({
            'workload': args.workload, 'seed': seed,
            'control': config['control'] if args.control else None,
            'fault': args.fault, 'mix': json.loads(args.mix),
            'correct': result['correct'], 'metrics': result['metrics'],
            'compared': {k: v['value']
                         for k, v in result['compared'].items()},
            'seconds': time.perf_counter() - t, 'where': where}),
            flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
