"""The fused device step: filter -> primer scores -> align over one batch.

Counterpart of ``fslr_tpu/parallel/step.py``: everything the pipeline
computes on the device for a fixed-shape read batch, as one function of
tensors, with the same ten arguments and the same outputs.  It runs on
the device of its tensors through the port's public ops: on the CPU
their plain versions, on a card their kernels (the repeat mask's
``mask_kernel``, ``sw_kernel`` for the concatemer grid and the primer
end windows, ``tb_kernel`` and ``walk_kernel`` for each candidate's
extension).  The JAX step runs the pure-JAX versions of its Pallas
kernels so that it compiles on CPU meshes; the Pallas variants are its
drop-in replacements on the TPU.

Stages, in the JAX step's scope:
  1. repeat mask + junk-block decision (with the given telomere table);
  2. a fixed-grid concatemer SW scan of the read interior;
  3. primer-target SW against both end windows;
  4. seeding of one strand, the traceback extension of the top
     min(max_candidates, 4) candidates (valid with at least
     min_chain_seeds seeds) against the genome window [0, G), and the
     split-selection DP.
The counters (reads kept / dropped by class, segments selected) are
sums of the per-read flags.

``make_sharded_step`` runs the step through ``parallel.dispatch.dp_call``
over a mesh: reads and lens are cut into row shards, the other eight
arguments are replicated, and the counters are computed once from the
gathered flags of the real rows (dp_call pads a batch by repeating its
last row).
"""

from __future__ import annotations

import torch

from fslr_tpu_torch.config import PipelineConfig
from fslr_tpu_torch.ops import kmer_stats, seed, selection, ssw, tantan
from fslr_tpu_torch.ops.banded import BW
from fslr_tpu_torch.ops.traceback import banded_extend
from fslr_tpu_torch.parallel import dispatch

NEG = -1e30


def _end_windows(reads, lens, window: int):
    """(start windows, end windows, usable length): the first and the
    last min(window, L) codes of each read, and min(len // 2, window)."""
    B, L = reads.shape
    W = min(window, L)
    idx = (torch.clamp_min(lens[:, None].long() - W, 0)
           + torch.arange(W, device=reads.device)[None, :])
    end_w = torch.gather(reads, 1, idx.clamp(max=L - 1))
    return reads[:, :W], end_w, torch.clamp_max(lens // 2, window)


def _tiled(x, n: int):
    """(B, ...) -> (B * n, ...): each row repeated n times in a row."""
    return x[:, None].expand(x.shape[0], n, *x.shape[1:]) \
        .reshape(x.shape[0] * n, *x.shape[1:])


def _stacked(x, B: int):
    """(n, ...) -> (B * n, ...): the whole table repeated B times."""
    return x[None].expand(B, *x.shape).reshape(B * x.shape[0],
                                               *x.shape[1:])


def counters(out: dict) -> dict:
    """The six counters of a step's per-read outputs (0-d int64
    tensors)."""
    junk, short, concat = out['junk'], out['short'], out['concat']
    drop = junk | short | concat
    return {'total_kept': (~drop).sum(), 'total_dropped': drop.sum(),
            'junk_seqs_dropped': junk.sum(),
            'short_seqs_dropped': (short & ~junk).sum(),
            'concatemers_dropped': (concat & ~junk & ~short).sum(),
            'aligned_segments': out['sel_chosen'].sum()}


def _per_read_step(config: PipelineConfig, L: int, n_seed_pos: int):
    jcfg, pcfg, acfg = config.junk, config.primer, config.align
    sc, asc = config.scoring, config.align.scoring
    n_cand = min(acfg.max_candidates, 4)

    def step(reads, lens, ptargets, ptlens, pseqs, pslens, tel_table,
             genome, counts, positions):
        if reads.shape[1] != L:
            raise ValueError(f'reads of width {reads.shape[1]}, the step '
                             f'was made for L = {L}')
        B = reads.shape[0]
        reads = reads.to(torch.uint8)
        lens = lens.to(torch.int32)
        dev = reads.device

        # ---- repeat mask + junk blocks ---------------------------------
        mask = tantan.repeat_mask(reads, lens, jcfg)
        junk = kmer_stats.junk_blocks(reads, lens, mask, jcfg,
                                      tel_table=tel_table)

        # ---- concatemer scan over a fixed window grid -------------------
        P2 = pseqs.shape[0]
        interior = torch.clamp_min(lens - 2 * jcfg.end_trim, 0)
        n_win = max(1, -(-(L - 2 * jcfg.end_trim) // jcfg.chunk_size))
        WT = min(L, jcfg.chunk_size + 2 * 64)
        wq = _stacked(pseqs, B)
        wql = _stacked(pslens, B)
        cscore = torch.full((B,), NEG, dtype=torch.float32, device=dev)
        for wi in range(n_win):
            widx = (jcfg.end_trim + wi * jcfg.chunk_size
                    + torch.arange(WT, device=dev)).clamp(max=L - 1)
            win_len = torch.clamp(interior - wi * jcfg.chunk_size, 0, WT)
            s, _, _ = ssw.sw_max(wq, _tiled(reads[:, widx], P2), wql,
                                 _tiled(win_len, P2), sc)
            cscore = torch.maximum(cscore, s.reshape(B, P2).max(dim=1)
                                   .values)
        concat = (cscore >= jcfg.concatemer_score) & \
            (lens >= jcfg.min_read_length)
        short = lens < max(jcfg.min_read_length, 2 * jcfg.end_trim + 1)

        # ---- primer scores on the end windows ---------------------------
        NP = ptargets.shape[0]
        start_w, end_w, space = _end_windows(reads, lens, pcfg.search_window)
        tq, tql, sl = _stacked(ptargets, B), _stacked(ptlens, B), \
            _tiled(space, NP)
        p1, _, _ = ssw.sw_max(tq, _tiled(start_w, NP), tql, sl, sc)
        p2, _, _ = ssw.sw_max(tq, _tiled(end_w, NP), tql, sl, sc)

        # ---- seed, extend the top candidates, select --------------------
        cand = seed.seed_candidates(
            reads, lens, counts, positions, k=acfg.seed_k,
            stride=acfg.seed_stride, occ_drop=acfg.occ_drop,
            band_w=acfg.band_width // 2, max_cand=n_cand, S=n_seed_pos,
            C=16)
        G = genome.shape[0]
        qs, qe, scs, vv = [], [], [], []
        for c in range(n_cand):
            ws = cand['diag'][:, c] - BW // 2
            packed, _ = banded_extend(reads, lens, ws, torch.zeros_like(ws),
                                      torch.full_like(ws, G), genome, asc)
            qs.append(packed[3])
            qe.append(packed[1] + 1)
            scs.append(packed[0].float())
            vv.append(cand['valid'][:, c].bool()
                      & (cand['count'][:, c] >= acfg.min_chain_seeds))
        qs, qe = torch.stack(qs, 1), torch.stack(qe, 1)
        scs, vv = torch.stack(scs, 1), torch.stack(vv, 1)
        chosen = selection._select(
            qs, qe, torch.where(vv, scs, NEG),
            vv & (scs >= acfg.min_selected_score), float(acfg.ol_cost),
            float(acfg.max_overlap))
        return dict(junk=junk, short=short, concat=concat,
                    p1_scores=p1.reshape(B, NP), p2_scores=p2.reshape(B, NP),
                    sel_qstart=qs, sel_qend=qe, sel_score=scs,
                    sel_chosen=chosen)

    return step


def make_device_step(config: PipelineConfig, n_primer_targets: int,
                     L: int, n_seed_pos: int):
    """The step for a fixed read length bucket ``L``.

    step(reads (B, L) u8, lens (B,) i32, ptargets (NP, 128) u8, ptlens
         (NP,), pseqs (P2, 128) u8, pslens (P2,), tel_table (5^6,) bool,
         genome (G,) u8, counts (4^k + 1,) i32, positions (N,) i32), all
    on one device, returns a dict: per read ``junk``, ``short``,
    ``concat`` (B,) bool, ``p1_scores`` / ``p2_scores`` (B, NP) f32,
    ``sel_qstart`` / ``sel_qend`` (B, C) i32, ``sel_score`` (B, C) f32
    (C = min(max_candidates, 4)), ``sel_chosen`` (B, C) bool, and
    ``counters`` (:func:`counters`).  ``n_primer_targets``
    is NP, kept for the JAX step's signature."""
    per_read = _per_read_step(config, L, n_seed_pos)

    def step(*args):
        out = per_read(*args)
        return dict(out, counters=counters(out))

    return step


def make_sharded_step(mesh, config: PipelineConfig, n_primer_targets: int,
                      L: int, n_seed_pos: int):
    """The step over ``mesh`` (a ``parallel.mesh.Mesh``): reads and lens
    in row shards, one per mesh entry, the other arguments replicated;
    the per-read outputs gathered on the mesh's first device and the
    counters summed from them, as ``psum`` gives them in the JAX step."""
    per_read = _per_read_step(config, L, n_seed_pos)

    def step(reads, lens, *tables):
        with dispatch.use_mesh(mesh):
            out = dispatch.dp_call(per_read, (reads, lens), tables)
        return dict(out, counters=counters(out))

    return step
