"""Command line of the PyTorch port, on argparse.

The options, names, defaults and help of ``fslr_tpu/cli.py`` (click), plus
``--device``.  Entry: ``python -m fslr_tpu_torch.cli`` or the
``fslr-tpu-torch`` console script; ``main(argv)`` runs in-process.
"""

from __future__ import annotations

import argparse
import os

import torch

import fslr_tpu_torch
from fslr_tpu_torch.config import ClusterConfig, PipelineConfig
from fslr_tpu_torch.parallel.mesh import Mesh, canonical, make_mesh


def _existing_path(p: str) -> str:
    if not os.path.exists(p):
        raise argparse.ArgumentTypeError(f"Path '{p}' does not exist.")
    return p


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog='fslr-tpu-torch',
        description='fslr on PyTorch: FASTQ folder + primer panel in; '
                    'BAM, mappings.bed, cluster beds and filter counts '
                    'out.')
    a = ap.add_argument
    a('--name', required=True, help='Sample name')
    a('--out', required=True, help='Output folder')
    a('--ref', required=True, help='Reference genome')
    a('--primers', required=True,
      help='Comma-separated list of primer names. Make sure these are '
           'listed in primers.csv')
    a('--basecalled',
      help='Folder of basecalled reads in fastq format to analyse')
    a('--trim-threshold', default=0.4, type=float,
      help='Threshold in range 0-1. Fraction of maximum primer alignment '
           'score; primer sites with lower scores are labelled False  '
           '[default: 0.4]')
    a('--keep-temp', action='store_true', help='Keep temp files')
    a('--regions', type=_existing_path,
      help='Target regions in bed form to perform biased mapping')
    a('--bias', default=1.05, type=float,
      help='Multiply alignment score by bias if alignment falls within '
           'target regions  [default: 1.05]')
    a('--procs', default=1, type=int,
      help='Number of processors to use  [default: 1]')
    a('--n-processes', default=1, type=int,
      help='Multi-host: total number of pipeline processes (each handles '
           'its input-file shard on its own chip(s); process 0 merges and '
           'clusters)  [default: 1]')
    a('--process-id', default=0, type=int,
      help="Multi-host: this process's id in [0, n_processes)  "
           '[default: 0]')
    a('--coordinator', default=None,
      help='Multi-host: torch.distributed (gloo) coordinator address '
           '(host:port), shared by all processes; process 0 serves it')
    a('--reference-mask', type=_existing_path,
      help='A bed file containing target regions for creating a masked '
           'reference. Reads are first aligned to the masked reference, '
           'prior to using the main reference')
    a('--skip-alignment', action='store_true', help='Skip alignment step')
    a('--skip-clustering', action='store_true', help='Skip clustering step')
    a('--jaccard-cutoffs', default='1,1,0.66,0.66,0.66,0.5',
      help='Comma-separated list of Jaccard similarity thresholds for N-1 '
           'intersections  [default: 1,1,0.66,0.66,0.66,0.5]')
    a('--overlap', default=0.8, type=float,
      help='Reciprocal interval overlap in range 0-1.  [default: 0.8]')
    a('--n-alignment-diff', default=0.25, type=float,
      help='How much the number of alignments in one cluster can differ. '
           'Fraction in the range 0-1.  [default: 0.25]')
    a('--qlen-diff', default=0.04, type=float,
      help='Max difference in query length. Fraction 0-1.  [default: 0.04]')
    a('--cluster-mask', default='subtelomere',
      help='Comma separated list of chromosome names to be excluded from '
           "the clustering. Use 'subtelomere' to exclude alignments within "
           '500kb of telomere end  [default: subtelomere]')
    a('--filter-high-coverage', action='store_true',
      help='Filter regions with high coverage')
    a('--filter-false', action='store_true',
      help='Use reads with both primers labeled')
    a('--consensus', dest='run_consensus', action='store_true',
      help='Run the per-cluster consensus + realign stage (documented in '
           'the reference but shipped disabled there; opt-in here)')
    a('--consensus-engine', default='poa', choices=('poa', 'pileup'),
      help="Consensus engine: 'poa' = profile-graph partial-order "
           "consensus (abpoa-grade), 'pileup' = single-round backbone vote "
           '(faster, less accurate on insertions)  [default: poa]')
    a('--mesh-devices', default=0, type=int,
      help='Shard every batched stage kernel data-parallel over this many '
           'devices of --device\'s type, --device\'s first (0 = all '
           'visible cards when there is more than one, 1 = single-device). '
           'Every card of the mesh holds a copy of the reference index, and '
           'several processes on one host each mesh every card with the '
           'default, so each card then holds a copy a process; give each '
           'process its own card with --device cuda:I --mesh-devices 1. '
           'Verified on one host with four cards, held to one card\'s '
           'artifacts (the README gives the memory and wall time); several '
           'hosts and more than four cards are not verified  [default: 0]')
    a('--device', default='cuda',
      help='torch device to run on (cuda, cuda:N or cpu); a CUDA device '
           'needs a card, there is no fallback to the CPU  [default: cuda]')
    a('--version', action='version', version=fslr_tpu_torch.__version__)
    return ap


def config_from_args(args: argparse.Namespace) -> PipelineConfig:
    """The PipelineConfig that fslr_tpu's CLI builds from the same
    options."""
    cluster = ClusterConfig(
        jaccard_cutoffs=tuple(float(x)
                              for x in args.jaccard_cutoffs.split(',')),
        overlap=args.overlap, qlen_diff=args.qlen_diff,
        n_alignment_diff=args.n_alignment_diff,
        cluster_mask=tuple(x for x in args.cluster_mask.split(',') if x),
        filter_high_coverage=args.filter_high_coverage,
        filter_false=args.filter_false)
    config = PipelineConfig(
        name=args.name, out=args.out, ref=args.ref,
        primers=tuple(args.primers.split(',')),
        basecalled=args.basecalled, regions=args.regions,
        reference_mask=args.reference_mask, keep_temp=args.keep_temp,
        skip_alignment=args.skip_alignment,
        skip_clustering=args.skip_clustering,
        run_consensus=args.run_consensus, procs=args.procs,
        n_processes=args.n_processes, process_id=args.process_id,
        coordinator=args.coordinator, cluster=cluster)
    return config.replace(
        consensus=config.consensus.__class__(
            **{**config.consensus.__dict__,
               'engine': args.consensus_engine}),
        primer=config.primer.__class__(
            trim_threshold=args.trim_threshold,
            search_window=config.primer.search_window),
        align=config.align.__class__(
            **{**config.align.__dict__, 'bias': args.bias}))


def mesh_from_args(args: argparse.Namespace, device: torch.device):
    """The mesh of ``--mesh-devices`` on ``device``'s type, or None for one
    device: 0 takes every visible card (the CPU counts as one device), n
    takes n of them, ``device`` first (n CPU entries on the CPU)."""
    n = args.mesh_devices
    if device.type == 'cpu':
        return make_mesh(n, 'cpu') if n > 1 else None
    cards = make_mesh().devices
    want = len(cards) if n == 0 else min(n, len(cards))
    if want <= 1:
        return None
    first = canonical(device)
    return Mesh(((first,) + tuple(d for d in cards if d != first))[:want])


def main(argv: list[str] | None = None):
    """Parse ``argv`` (sys.argv[1:] when None) and run the pipeline."""
    from fslr_tpu_torch.pipeline import run_pipeline
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'--device {args.device}: no CUDA card is '
                           'available (use --device cpu to run on the CPU)')
    run_pipeline(config_from_args(args), device,
                 mesh=mesh_from_args(args, device))


if __name__ == '__main__':
    main()
