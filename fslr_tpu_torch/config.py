"""Typed configuration for the fslr-tpu pipeline.

Every hard-coded constant of the reference pipeline becomes a named field here
(reference survey: SURVEY.md section 5.6).  Citations point into the reference
fslr repository (the original pipeline) for parity checking:

- trim_threshold 0.4            -> fslr/main.py:25
- junk block length 150         -> fslr/filter_junk_from_fq.py:123
- telomere pct 0.3 / rep 0.3    -> fslr/filter_junk_from_fq.py:143,146
- min read length 200           -> fslr/filter_junk_from_fq.py:66
- end trim 100                  -> fslr/filter_junk_from_fq.py:70
- concatemer score 28           -> fslr/filter_junk_from_fq.py:93,104
- concatemer chunk 10_000       -> fslr/filter_junk_from_fq.py:79
- primer search window 500      -> fslr/find_reads_with_primers.py:51
- bwa scoring A2 B3 O5 E2 k11   -> fslr/main.py:125
- dodi ol-cost 2, max-overlap 50_000, bias 1.05 -> fslr/main.py:137,28
- jaccard cutoffs / overlap 0.8 / qlen diff 0.04 / n-aln diff 0.25
                                -> fslr/main.py:33-36
- edge_threshold 10             -> fslr/main.py:221
- subtelomere threshold 500 kb  -> fslr/main.py:237
- high coverage threshold 10000 -> fslr/main.py:235
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ScoringConfig:
    """Alignment scoring parameters.

    ``gap_open_is_first_base`` selects the gap-cost convention:
      * True  : a gap of length g costs open + (g-1)*extend  (SSW library /
                scikit-bio convention, used for primer scans).
      * False : a gap of length g costs open + g*extend       (bwa convention,
                used by the seed-and-extend aligner; reference flags
                -A2 -B3 -O5 -E2 at fslr/main.py:125).
    """

    match: int = 2
    mismatch: int = -3
    gap_open: int = 5
    gap_extend: int = 2
    gap_open_is_first_base: bool = True


@dataclasses.dataclass(frozen=True)
class JunkFilterConfig:
    """Stage A: junk / concatemer filter (fslr/filter_junk_from_fq.py)."""

    min_block_length: int = 150          # lowercase block length threshold
    telomere_pct_threshold: float = 0.3  # telmer_pct > 0.3 => keep looking
    rep_threshold: float = 0.3           # compute_rep >= 0.3 => junk
    min_read_length: int = 200           # reads shorter than this are dropped
    end_trim: int = 100                  # interior trim for concatemer scan
    concatemer_score: int = 28           # SW score to call a concatemer
    chunk_size: int = 10_000             # interior scan chunk size
    chunk_overlap_pad: int = 10          # chunk overlap = len(primer) + pad
    # tantan-equivalent repeat masking model (ops/tantan.py)
    mask_max_period: int = 100
    mask_repeat_start: float = 0.005
    mask_repeat_end: float = 0.05
    mask_decay: float = 0.9
    mask_match_prob: float = 0.9
    mask_posterior_threshold: float = 0.5


@dataclasses.dataclass(frozen=True)
class PrimerConfig:
    """Stage B: primer identification + trim (fslr/find_reads_with_primers.py)."""

    trim_threshold: float = 0.4   # fraction of max score; below => 'False'
    search_window: int = 500      # bp scanned at each read end


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Seed-chain-extend aligner replacing bwa mem + dodi selection.

    The seeding/chaining design is TPU-native (fixed-stride exact k-mer seeds,
    diagonal binning) rather than a transcription of bwa's FM-index SMEMs; the
    scoring parameters mirror the reference bwa invocation (fslr/main.py:125).
    """

    seed_k: int = 11                # bwa -k 11
    seed_stride: int = 3            # query positions sampled for seeding
    max_kmer_occ: int = 16          # per-seed hit cap (occurrences above
                                    # this are sampled evenly; bwa -c analog)
    occ_drop: int = 1000            # k-mers occurring more often than this
                                    # in the genome are dropped from seeding
                                    # entirely (bwa -c 1000,
                                    # fslr/main.py:125)
    band_width: int = 128           # diagonal band half-width for extension
    max_candidates: int = 16        # diagonal bands extended per read/strand
    extension_margin: int = 256     # bp extended beyond the seed span
    min_chain_seeds: int = 2        # bands with fewer seeds are discarded
    min_band_span: int = 18         # min query span (bp) of a band's seeds
    # bwa mem chain filtering (mem_chain_flt): a band overlapped by a kept
    # band over >= mask_level of its query span is dropped when its seed
    # count is < drop_ratio x the kept band's (bwa -D 0.25 at
    # fslr/main.py:125; mask_level is bwa's 0.5 default)
    chain_mask_level: float = 0.5
    chain_drop_ratio: float = 0.25
    scoring: ScoringConfig = dataclasses.field(
        default_factory=lambda: ScoringConfig(gap_open_is_first_base=False))
    # dodi-equivalent selection (fslr/main.py:137)
    ol_cost: int = 2                # dodi --ol-cost 2
    max_overlap: int = 50_000       # dodi --max-overlap 50000
    bias: float = 1.05              # dodi --bias (with --regions)
    min_selected_score: int = 21    # dodi -u 21 (min alignment score kept)
    # bwa z-drop (reference invocation -d 200, fslr/main.py:125): an
    # extension whose score drops by more than zdrop is terminated, so a
    # candidate band fusing two near-diagonal segments yields TWO
    # alignments instead of one bridged by a giant indel.  Here the
    # equivalent CIGAR-level rule: split selected alignments at interior
    # indel runs whose affine penalty exceeds zdrop
    # (stages/align._zdrop_split_rows); 0 disables splitting.
    zdrop: int = 200


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Breakpoint clustering (fslr/cluster.py + fslr/main.py:190-352)."""

    jaccard_cutoffs: Sequence[float] = (1.0, 1.0, 0.66, 0.66, 0.66, 0.5)
    overlap: float = 0.8
    edge_threshold: int = 10
    qlen_diff: float = 0.04
    n_alignment_diff: float = 0.25
    cluster_mask: Sequence[str] = ('subtelomere',)
    subtelomere_threshold: int = 500_000
    min_masked_chrom_length: int = 1_000_000
    high_coverage_threshold: int = 10_000
    filter_high_coverage: bool = False
    filter_false: bool = False
    max_intervals_per_read: int = 32   # fixed-shape cap for the Jaccard kernel
    # When a query reaches the soft edge cap (edge_threshold), the
    # reference walk's seen_edges bookkeeping becomes dynamic (skipped
    # pairs are re-testable, cluster.py:205-224) and the closed-form
    # first-encounter replay is no longer bit-exact on EDGES (components
    # are unaffected in every observed case; the output beds depend only
    # on components).  With this flag the host path replays capped walks
    # exactly over the full multi-occurrence stream; the device/spill
    # scale paths always use the closed form (see ops/capwalk.py).
    exact_cap_replay: bool = True
    # encounter streams of this size and above take the scale path: the
    # encounters are enumerated and reduced to pairs on the device
    # (ops/encounters.py) and the capped walk is valued and replayed there
    # (ops/capwalk.py).  Below it the host path is exact under capping.
    device_enum_min_encounters: int = 4_000_000
    # encounters expanded per device slice (bounds a slice's temporaries)
    enum_slice_cap: int = 32 * 1024 * 1024
    # slice results merge into the accumulator once this many encounters
    # are held (or three slices)
    enum_merge_cap: int = 96 * 1024 * 1024
    # encounter streams up to this size keep their pairs in one set on
    # the device (the in-HBM path of ops/encounters.py); larger ones up to
    # encounters.SPILL_DIRECT_MIN in pk-range and query-range buckets on
    # the device (the sharded path, 12 B a pair resident), and larger ones
    # still in host memory (the spill).  Set for an 80 GB card: the
    # in-HBM path's peak is 52.4 B a read pair (chip_smoke.py phase 9 and
    # cluster_paths on an H100 80GB at 1.0M and 2.0M reads; PERF.md
    # section 6), and a pair is met at least twice (once from each read),
    # so 2^31 encounters stay under ~56 GB.  No artifact depends on it.
    enum_spill_min_encounters: int = 1 << 31


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """Per-cluster consensus (documented stage, reference README.rst:125-137)."""

    max_reads_per_cluster: int = 16
    max_length: int = 32_768
    poa_band: int = 128
    engine: str = 'poa'          # 'poa' (profile-graph POA, abpoa-grade)
                                 # or 'pileup' (single-round backbone vote)
    refine_iterations: int = 0   # extra pileups against the consensus
                                 # (off by default: the backbone self-vote
                                 # biases against corrections on noisy
                                 # clusters; see tests/test_consensus.py)


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """Bucketing / padding policy for device batches."""

    # ~1.5x steps: amplicon datasets cluster at one read length, so the
    # bucket just above it sets the padding waste of every seeding /
    # masking batch (pow2-only buckets waste up to 50%)
    length_buckets: Sequence[int] = (512, 768, 1024, 1536, 2048, 3072,
                                     4096, 6144, 8192, 12288, 16384,
                                     24576, 32768)
    batch_size: int = 512

    # Streamed alignment: the pipeline aligns labelled reads in chunks of
    # this many, encoding BAM records and mapping-table rows per chunk so
    # peak host memory is bounded by the chunk (configs 4-5, 1M-10M
    # reads), not the dataset.  Artifacts are byte-identical to an
    # unchunked run (tests/test_pipeline.py).
    align_stream_reads: int = 65536


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level configuration mirroring the reference CLI (fslr/main.py:20-40)."""

    name: str = 'sample'
    out: str = '.'
    ref: str | None = None
    primers: Sequence[str] = ()
    basecalled: str | None = None
    regions: str | None = None
    reference_mask: str | None = None
    keep_temp: bool = False
    skip_alignment: bool = False
    skip_clustering: bool = False
    run_consensus: bool = False   # the reference ships this stage disabled
    exact_cigars: bool = True     # traceback-kernel CIGARs in the BAM
    procs: int = 1
    # multi-HOST execution (SURVEY section 5.8; the reference's only
    # parallelism is Pool.map over input files, main.py:95-114 — here the
    # file shard is per PROCESS and each process drives its own chip(s)):
    # every process runs filter->primer->align on files[pid::n], counters
    # reduce globally, and process 0 merges the per-process artifacts and
    # runs clustering.
    n_processes: int = 1
    process_id: int = 0
    coordinator: str | None = None   # jax.distributed coordinator addr

    scoring: ScoringConfig = dataclasses.field(default_factory=ScoringConfig)
    junk: JunkFilterConfig = dataclasses.field(default_factory=JunkFilterConfig)
    primer: PrimerConfig = dataclasses.field(default_factory=PrimerConfig)
    align: AlignConfig = dataclasses.field(default_factory=AlignConfig)
    cluster: ClusterConfig = dataclasses.field(default_factory=ClusterConfig)
    consensus: ConsensusConfig = dataclasses.field(default_factory=ConsensusConfig)
    batch: BatchConfig = dataclasses.field(default_factory=BatchConfig)

    def replace(self, **kw) -> 'PipelineConfig':
        return dataclasses.replace(self, **kw)
