"""Connected components of edges held in shards over the mesh.

Counterpart of ``fslr_tpu/parallel/cluster_merge.py``: each mesh entry
holds the edges of its own read shard (over global node ids); the edges
are all-gathered, so every entry holds all of them, and every entry labels
the same graph, so the labels need no further exchange.  The graph is
small beside the read data.  Since every entry's labels are the same by
construction, the gather here is a copy of every shard to the first mesh
device, which labels the graph once.
"""

from __future__ import annotations

import numpy as np
import torch

from fslr_tpu_torch.ops.components import connected_components
from fslr_tpu_torch.parallel.mesh import Mesh


def merged_components(mesh: Mesh, edges_per_shard: list, n_nodes: int,
                      max_local_edges: int) -> np.ndarray:
    """Labels (n_nodes,) of the graph whose edges are ``edges_per_shard``.

    Args:
      edges_per_shard: one (E_i, 2) array of global node-id pairs per
        mesh entry; each is padded to ``max_local_edges`` with (0, 0)
        self-loops, which cannot change a label.
      n_nodes: the global node count.
    Returns int64 labels (a component's smallest node id), computed on
    the first mesh entry's device.
    """
    if len(edges_per_shard) != mesh.size:
        raise ValueError(f'need {mesh.size} shards, got '
                         f'{len(edges_per_shard)}')
    local = []
    for e, dev in zip(edges_per_shard, mesh.devices):
        e = np.asarray(e, np.int64).reshape(-1, 2)
        if len(e) > max_local_edges:
            raise ValueError(f'{len(e)} local edges > cap {max_local_edges}')
        local.append(torch.as_tensor(np.concatenate(
            [e, np.zeros((max_local_edges - len(e), 2), np.int64)]),
            device=dev))
    dev = mesh.devices[0]
    return connected_components(torch.cat([t.to(dev) for t in local]),
                                n_nodes, dev)
