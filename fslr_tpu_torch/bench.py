"""End-to-end bench of the PyTorch port: synthetic amplicons -> reads/s.

The counterpart of the repo's ``bench.py`` (the JAX package on a TPU),
with its modes, flags and output keys, plus ``--device`` (default
``cuda``; a CUDA device needs a card, there is no fallback to the CPU):

    python -m fslr_tpu_torch.bench [--device cuda] [--skip-10k]
    python -m fslr_tpu_torch.bench --consensus [--reads N]
    python -m fslr_tpu_torch.bench --scale N [--groups G]
    python -m fslr_tpu_torch.bench --cluster-scale N
    python -m fslr_tpu_torch.bench --cpu-baseline

* default: the full pipeline (filter -> primer ID -> align -> BAM +
  mappings.bed -> clustering) on ``tools.synth.make_dataset``'s 1,000
  reads in 20 groups, one warm-up and the best of 3 runs, then the same
  at 10,000 reads (unless ``--skip-10k``); ``vs_baseline`` against the
  port's own run on the host CPU (its plain PyTorch versions of every
  kernel: ``--cpu-baseline``, run once in a subprocess and cached in
  ``fslr_tpu_torch/_build/bench_baseline.json``).  The reference's native
  tools are not part of the repo, so it is no ratio against fslr itself;
* ``--consensus``: the same with the consensus stage, on N reads (10,000
  by default) in N / 20 groups;
* ``--scale N``: one run of the default pipeline at N reads in G groups
  (N / 700 by default, at least 20);
* ``--cluster-scale N``: clustering alone (query_graph + components) on
  ``tools.synth.make_cluster_scale_data``'s N reads in groups of 700,
  the edges of 5 groups checked against the exact host path, each group
  alone (the check raises on a mismatch).

Each mode prints ONE JSON line on stdout (its metric names the device: a
card by ``nvidia-smi``'s name and power limit); everything else goes to
stderr.  The pipeline runs on one device, without a mesh.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fslr_tpu_torch import instrument
from fslr_tpu_torch.tools.synth import make_cluster_scale_data, make_dataset

N_READS = 1000
N_READS_CPU = 1000
_HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE_CACHE = os.path.join(_HERE, '_build', 'bench_baseline.json')


def device_name(device: torch.device) -> str:
    """A card's ``nvidia-smi`` name and power limit (``NVIDIA H100 80GB
    HBM3, 700.00 W``), or ``host CPU``."""
    if device.type != 'cuda':
        return 'host CPU'
    lines = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.splitlines()
    return lines[device.index or 0].strip()


def run_once(root, ref_path, fq_dir, tag, device, consensus=False):
    """One pipeline run into ``{root}/out_{tag}``; returns (wall s, stage
    seconds, DP cells by tag)."""
    from fslr_tpu_torch.config import PipelineConfig
    from fslr_tpu_torch.pipeline import run_pipeline

    out = os.path.join(root, f'out_{tag}')
    config = PipelineConfig(name='B', out=out, ref=ref_path,
                            primers=('21q1', '17p6'), basecalled=fq_dir,
                            run_consensus=consensus)
    instrument.reset_cells()
    t0 = time.perf_counter()
    # keep stdout for the one JSON line
    with contextlib.redirect_stdout(sys.stderr):
        run_pipeline(config, device)
    dt = time.perf_counter() - t0
    with open(os.path.join(out, 'B.timings.json')) as fh:
        stages = json.load(fh)['timings_s']
    return dt, stages, instrument.cell_counts()


def measure(tag, device, n_reads=N_READS, repeats=3, consensus=False,
            n_groups=20):
    """One warm-up run (kernel build, index cache), then ``repeats`` runs.
    Returns reads/s of the best run with the spread (min / median / max
    wall, every run's stage seconds) and its DP cells."""
    with tempfile.TemporaryDirectory(prefix='fslr_bench_') as root:
        ref_path, fq_dir = make_dataset(root, n_reads, n_groups)
        run_once(root, ref_path, fq_dir, tag + '_warm', device,
                 consensus=consensus)
        runs = [run_once(root, ref_path, fq_dir, f'{tag}{r}', device,
                         consensus=consensus)
                for r in range(repeats)]
    walls = sorted(r[0] for r in runs)
    dt, stages, cells = min(runs, key=lambda r: r[0])
    align_s = stages.get('align', 0.0)
    return {
        'reads_per_s': n_reads / dt,
        'wall_s': round(dt, 2),
        'wall_s_runs': [round(r[0], 2) for r in runs],
        'wall_s_min_med_max': [round(walls[0], 2),
                               round(walls[len(walls) // 2], 2),
                               round(walls[-1], 2)],
        'stage_s': {k: round(v, 3) for k, v in sorted(
            stages.items(), key=lambda x: -x[1])},
        'stage_s_runs': [{k: round(v, 3) for k, v in r[1].items()}
                         for r in runs],
        'dp_cells': cells,
        'dp_cells_per_s': int(sum(cells.values()) / dt),
        'align_dp_cells_per_s': (int(cells.get('extend', 0) / align_s)
                                 if align_s else 0),
        'stage_cells_per_s': stage_cells_per_s(cells, stages),
    }


# cell tag -> the pipeline stage that does the work
_TAG_STAGE = {'seed': 'align', 'extend': 'align', 'select': 'align',
              'sw_primer': 'find_primers', 'sw_concat': 'filter_junk',
              'hmm': 'filter_junk', 'jaccard': 'clustering',
              'profile': 'consensus'}


def stage_cells_per_s(cells, stages):
    per: dict = {}
    for tag, n in cells.items():
        st = _TAG_STAGE.get(tag, tag)
        per[st] = per.get(st, 0) + n
    return {st: int(n / stages[st]) for st, n in per.items()
            if stages.get(st, 0) > 0.05}


def run_scale(n_reads, n_groups, device, root=None):
    """One run at ``n_reads`` in ``n_groups`` groups (a group's pair set
    grows with the square of its size, so groups stay at a realistic
    size); prints the JSON line and returns it.  With ``root`` the
    dataset and the run's artifacts (``{root}/out_scale/B.*``) stay
    there."""
    with (contextlib.nullcontext(root) if root else
          tempfile.TemporaryDirectory(prefix='fslr_scale_')) as root:
        t0 = time.perf_counter()
        ref_path, fq_dir = make_dataset(root, n_reads, n_groups)
        print(json.dumps({'dataset_s': round(time.perf_counter() - t0, 1)}),
              file=sys.stderr)
        dt, stages, cells = run_once(root, ref_path, fq_dir, 'scale', device)
    name = device_name(device)
    line = {
        'metric': f'end-to-end pipeline reads/s ({n_reads} synthetic '
                  f'fusion reads, {n_groups} breakpoint groups; {name}, '
                  f'single run)',
        'value': round(n_reads / dt, 2),
        'unit': 'reads/s',
        'device': name,
        'wall_s': round(dt, 1),
        'stage_s': {k: round(v, 2) for k, v in sorted(
            stages.items(), key=lambda x: -x[1])},
        'dp_cells': cells,
        'stage_cells_per_s': stage_cells_per_s(cells, stages),
    }
    print(json.dumps(line))
    return line


def verify_groups(data, edges, group, groups, device):
    """Groups lie 5 kb apart, so a group's walk depends on its own entries
    only: the edges of each group in ``groups`` (read r is in group
    r // ``group``) must be those of the exact host path on that group
    alone (the closed-form replay, as at scale).  Raises on a mismatch;
    returns the number of groups checked."""
    from fslr_tpu_torch.config import ClusterConfig
    from fslr_tpu_torch.stages import cluster as C

    host = ClusterConfig(device_enum_min_encounters=1 << 62,
                         exact_cap_replay=False)
    by_group: dict = {int(g): set() for g in groups}
    for a, b in edges:
        if int(a) // group in by_group:
            by_group[int(a) // group].add(tuple(sorted((int(a), int(b)))))
    for g in groups:
        g = int(g)
        rows = [it for it in data if it.qname // group == g]
        _, e2, _ = C.query_graph(
            rows, host.overlap, list(host.jaccard_cutoffs),
            host.edge_threshold, host.qlen_diff, host.n_alignment_diff,
            host, device)
        want = {tuple(sorted((int(a), int(b)))) for a, b in e2}
        if want != by_group[g]:
            raise AssertionError(
                f'group {g}: the edge set at scale differs from the host '
                f'path on the group alone ({len(by_group[g])} edges '
                f'against {len(want)})')
    return len(groups)


def run_cluster_scale(n_reads, device, group=700, n_verify=5):
    """Clustering at the 10M-read design point's shape (config-5),
    alone: one interior interval a read in groups of ``group``
    (tools.synth.make_cluster_scale_data), query_graph + components on
    ``device``, then :func:`verify_groups` on ``n_verify`` groups spread
    over the pair keys.  Prints the JSON line and returns it."""
    from fslr_tpu_torch.config import ClusterConfig
    from fslr_tpu_torch.stages import cluster as C

    n_groups = max(1, n_reads // group)
    print(json.dumps({'cluster_scale': n_reads, 'groups': n_groups,
                      'group_size': group,
                      'est_pairs': n_groups * group * (group - 1) // 2}),
          file=sys.stderr)
    t0 = time.perf_counter()
    data = make_cluster_scale_data(n_reads, group, seed=7)
    print(json.dumps({'data_build_s': round(time.perf_counter() - t0, 1)}),
          file=sys.stderr)
    # the closed-form capped walk, as the scale paths replay it, so that a
    # small run (host path) measures and checks the same semantics
    cfg = ClusterConfig(exact_cap_replay=False)
    t0 = time.perf_counter()
    _, edges, node_pos = C.query_graph(
        data, cfg.overlap, list(cfg.jaccard_cutoffs), cfg.edge_threshold,
        cfg.qlen_diff, cfg.n_alignment_diff, cfg, device)
    subgraphs = C.get_subgraphs(edges, node_pos, device)
    wall = time.perf_counter() - t0
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    verified = verify_groups(
        data, edges, group,
        np.linspace(0, n_groups - 1, n_verify).astype(np.int64), device)
    name = device_name(device)
    line = {
        'metric': f'breakpoint clustering, {n_reads} reads in {n_groups} '
                  f'groups of {group} (config-5 design point; {name})',
        'value': round(n_reads / wall, 2),
        'unit': 'reads/s',
        'device': name,
        'wall_s': round(wall, 1),
        'n_edges': len(edges),
        'n_clusters': len(subgraphs),
        'peak_rss_gb': round(rss_gb, 1),
        'verified_groups': verified,
    }
    print(json.dumps(line))
    return line


def cpu_baseline() -> float:
    """The port's reads/s on the host CPU (``--cpu-baseline`` in a
    subprocess), cached in BASELINE_CACHE."""
    if os.path.exists(BASELINE_CACHE):
        with open(BASELINE_CACHE) as fh:
            return json.load(fh)['cpu_reads_per_s']
    proc = subprocess.run(
        [sys.executable, '-m', 'fslr_tpu_torch.bench', '--cpu-baseline'],
        capture_output=True, text=True, timeout=3600,
        cwd=os.path.dirname(_HERE))
    if proc.returncode:
        raise RuntimeError('--cpu-baseline failed:\n' + proc.stderr[-4000:])
    baseline = json.loads(proc.stdout.splitlines()[-1])['cpu_reads_per_s']
    os.makedirs(os.path.dirname(BASELINE_CACHE), exist_ok=True)
    with open(BASELINE_CACHE, 'w') as fh:
        json.dump({'cpu_reads_per_s': baseline}, fh)
    return baseline


def _parser():
    ap = argparse.ArgumentParser(
        prog='python -m fslr_tpu_torch.bench',
        description='End-to-end bench of fslr_tpu_torch (see the module '
                    'doc); one JSON line on stdout.')
    ap.add_argument('--device', default='cuda',
                    help='torch device (cuda, cuda:N or cpu); a CUDA '
                         'device needs a card  [default: cuda]')
    ap.add_argument('--consensus', action='store_true')
    ap.add_argument('--reads', type=int, default=10 * N_READS)
    ap.add_argument('--scale', type=int)
    ap.add_argument('--groups', type=int)
    ap.add_argument('--cluster-scale', type=int)
    ap.add_argument('--cpu-baseline', action='store_true')
    ap.add_argument('--skip-10k', action='store_true')
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.cpu_baseline:
        r = measure('cpu', torch.device('cpu'), N_READS_CPU, repeats=3)
        print(json.dumps({'cpu_reads_per_s': r['reads_per_s']}))
        return
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'--device {args.device}: no CUDA card is '
                           'available (use --device cpu for the CPU)')
    name = device_name(device)
    if args.consensus:
        # many clusters of ~20 reads, so that the POA engine sees n / 20
        # profile graphs a run
        n = args.reads
        groups = max(20, n // 20)
        r = measure('cons', device, n_reads=n, repeats=3, consensus=True,
                    n_groups=groups)
        cells = r['dp_cells']
        cons_s = r['stage_s'].get('consensus', 0.0)
        print(json.dumps({
            'metric': f'end-to-end pipeline + POA consensus reads/s ({n} '
                      f'synthetic fusion reads, {groups} clusters; {name})',
            'value': round(r['reads_per_s'], 2),
            'unit': 'reads/s',
            'device': name,
            'wall_s': r['wall_s'],
            'wall_s_min_med_max': r['wall_s_min_med_max'],
            'stage_s': r['stage_s'],
            'profile_cells': cells.get('profile', 0),
            'profile_cells_per_s': (int(cells.get('profile', 0) / cons_s)
                                    if cons_s else 0),
            'stage_cells_per_s': r['stage_cells_per_s'],
        }))
        return
    if args.cluster_scale is not None:
        run_cluster_scale(args.cluster_scale, device)
        return
    if args.scale is not None:
        groups = args.groups or max(20, args.scale // 700)
        run_scale(args.scale, groups, device)
        return

    baseline = cpu_baseline()
    r = measure('dev', device, n_reads=N_READS)
    r10k = (None if args.skip_10k else
            measure('dev10k', device, n_reads=10 * N_READS, repeats=3))
    out = {
        'metric': f'end-to-end pipeline reads/s (1k synthetic fusion reads, '
                  f'2-primer panel; {name}). vs_baseline = the port\'s own '
                  f'plain PyTorch run on the host CPU; the reference '
                  f'pipeline\'s native tools (bwa/dodi/tantan) are not part '
                  f'of the repo, so this is NOT a measured ratio vs fslr '
                  f'itself',
        'value': round(r['reads_per_s'], 2),
        'unit': 'reads/s',
        'device': name,
        'vs_baseline': (round(r['reads_per_s'] / baseline, 2)
                        if baseline else None),
        'wall_s_min_med_max': r['wall_s_min_med_max'],
        'wall_s_runs': r['wall_s_runs'],
        'stage_s': r['stage_s'],
        'stage_s_runs': r['stage_s_runs'],
        'align_dp_cells_per_s': r['align_dp_cells_per_s'],
        'dp_cells_per_s': r['dp_cells_per_s'],
        'stage_cells_per_s': r['stage_cells_per_s'],
    }
    if r10k is not None:
        out['reads_per_s_10k'] = round(r10k['reads_per_s'], 2)
        out['wall_s_min_med_max_10k'] = r10k['wall_s_min_med_max']
        out['wall_s_runs_10k'] = r10k['wall_s_runs']
        out['stage_s_10k'] = r10k['stage_s']
        out['stage_s_runs_10k'] = r10k['stage_s_runs']
        out['align_dp_cells_per_s_10k'] = r10k['align_dp_cells_per_s']
        out['stage_cells_per_s_10k'] = r10k['stage_cells_per_s']
    print(json.dumps(out))


if __name__ == '__main__':
    main()
