"""Connected components by min-label propagation with pointer jumping.

Counterpart of ``fslr_tpu/ops/components.py``: every node starts with its
own id as label; each round takes the smaller label across every edge
(``scatter_reduce`` with ``amin``) and jumps pointers twice, until no label
changes.  A label is the smallest node id in its component.  Runs as torch
ops on the device of the edge tensor; there is no padding (the JAX version
padded node and edge counts to powers of two for compile reuse).
"""

from __future__ import annotations

import numpy as np
import torch


def connected_components(edges, n_nodes: int,
                         device: torch.device) -> np.ndarray:
    """edges: (E, 2) node ids (may be empty; an array or a tensor),
    moved to ``device`` (the caller names it: a CUDA card, or the CPU).
    Returns (n_nodes,) int64 labels on the host, label = smallest node id
    of the component."""
    if isinstance(edges, torch.Tensor):
        e = edges.to(device=device, dtype=torch.int64).reshape(-1, 2)
    else:
        e = torch.as_tensor(np.asarray(edges, np.int64).reshape(-1, 2),
                            device=device)
    labels = torch.arange(n_nodes, dtype=torch.long, device=e.device)
    if e.shape[0] == 0:
        return labels.cpu().numpy()
    e0, e1 = e[:, 0], e[:, 1]
    while True:
        m = torch.minimum(labels[e0], labels[e1])
        new = labels.scatter_reduce(0, e0, m, 'amin') \
            .scatter_reduce(0, e1, m, 'amin')
        new = new[new]          # pointer jumps
        new = new[new]
        if torch.equal(new, labels):
            return labels.cpu().numpy()
        labels = new
