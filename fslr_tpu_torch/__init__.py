"""fslr_tpu_torch: the fslr-tpu engine on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

Beside the JAX package ``fslr_tpu`` (the reference), this package runs the
same filter -> primer -> align -> BAM + mappings.bed -> breakpoint
clustering [-> per-cluster consensus] path on an explicit
``torch.device``: plain PyTorch on the CPU, the kernels of ``csrc/`` on a
CUDA card.  It imports nothing of ``fslr_tpu``: its host modules (config,
encoding, panel, FASTQ/BAM I/O, reference index, stage timer) are its own
copies, with the same dataclasses, defaults and file formats.
"""

__version__ = '0.1.0'
