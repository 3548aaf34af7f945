"""The multi-process bootstrap (``initialize_distributed`` of
``fslr_tpu/parallel/cluster_merge.py``).

``initialize_distributed`` starts the ``torch.distributed`` process group
of a multi-process run.  It uses gloo: what crosses processes is host
data (a counter dict and a barrier), and NCCL refuses two ranks on one
card, which a one-card machine running two processes needs.

That module's other half, the connected components of the cluster
graph's edge shards over a mesh, is ``parallel/cluster_merge.py``.
Each process of a group drives its own card (``--device cuda:i``); what
crosses processes stays on the host.
"""

from __future__ import annotations

import datetime

import torch.distributed as dist

# seconds a collective (the group's rendezvous included) may wait for a
# peer before it raises.  The group is joined after each process's
# stages, so a process that finishes early waits here for the slowest:
# the default (a week) outlasts any run's skew between processes and
# only ends a wait for a peer that is gone.  A caller may set it before
# the group starts (tests set seconds).
TIMEOUT_S = 7 * 24 * 3600.0


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None):
    """Join the gloo process group at ``tcp://{coordinator}`` (host:port;
    process 0 serves it) as rank ``process_id`` of ``num_processes``; a
    collective that waits longer than ``TIMEOUT_S`` raises.  A no-op for
    one process, and when a group already exists (a caller may start it
    first)."""
    if num_processes is None or num_processes <= 1 or dist.is_initialized():
        return
    dist.init_process_group(
        'gloo', init_method=f'tcp://{coordinator}',
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
