"""The mesh merge of clustering's components (fslr_tpu_torch/parallel/
cluster_merge.py and the mesh branch of stages/cluster.get_subgraphs)
against fslr_tpu's on the CPU: exact labels and component lists."""

import jax  # noqa: F401  (tests/conftest.py gives JAX 8 CPU devices)
import numpy as np
import pytest
import torch

from fslr_tpu.config import ClusterConfig
from fslr_tpu.ops import components as jcomp
from fslr_tpu.parallel import cluster_merge as jmerge
from fslr_tpu.parallel import dispatch as jdispatch
from fslr_tpu.parallel import mesh as jmesh
from fslr_tpu.stages import cluster as jC
from fslr_tpu_torch.ops import components as tcomp
from fslr_tpu_torch.parallel import cluster_merge as tmerge
from fslr_tpu_torch.parallel import dispatch as tdispatch
from fslr_tpu_torch.parallel.mesh import make_mesh
from fslr_tpu_torch.stages import cluster as tC
from tests.test_cluster import _mixed_dataset
from tests.test_torch_encounters import _data

CPU = torch.device('cpu')


@pytest.mark.parametrize('n_dev,seed', [(4, 0), (2, 1), (3, 2)])
def test_merged_components_match_fslr_tpu(n_dev, seed):
    """tests/test_parallel.py's case (seed 0: 40 random edges over 64
    nodes in 4 shards of at most 16), and two more meshes: equal to
    fslr_tpu's merge on its CPU mesh and to connected_components."""
    rng = np.random.default_rng(seed)
    n_nodes = 64
    edges = rng.integers(0, n_nodes, size=(40, 2)).astype(np.int32)
    shards = np.array_split(edges, n_dev)
    cap = max(len(s) for s in shards) + 2
    want = np.asarray(jmerge.merged_components(jmesh.make_mesh(n_dev),
                                               shards, n_nodes, cap))
    got = tmerge.merged_components(make_mesh(n_dev, 'cpu'), shards,
                                   n_nodes, cap)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tcomp.connected_components(edges, n_nodes, CPU))
    np.testing.assert_array_equal(
        got, np.asarray(jcomp.connected_components_padded(edges, n_nodes)))


@pytest.mark.parametrize('fault', ['shard_count', 'local_edges'])
def test_merged_components_refuse_as_fslr_tpu(fault):
    """A shard list of the wrong length, or a shard over
    max_local_edges: both packages raise ValueError with one message."""
    edges = np.array([[0, 1], [1, 2], [3, 4]], np.int32)
    shards, cap = (([edges], 3) if fault == 'shard_count'
                   else ([edges[:1], edges[1:]], 1))
    with pytest.raises(ValueError) as want:
        jmerge.merged_components(jmesh.make_mesh(2), shards, 5, cap)
    with pytest.raises(ValueError) as got:
        tmerge.merged_components(make_mesh(2, 'cpu'), shards, 5, cap)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope='module')
def mixed_graph():
    """fslr_tpu's edges and node order of the mixed scenario (host
    path), and its components without a mesh and under a mesh of 2."""
    data = _data(_mixed_dataset())
    cfg = ClusterConfig()
    _, edges, node_pos = jC.query_graph(
        data, cfg.overlap, list(cfg.jaccard_cutoffs), cfg.edge_threshold,
        cfg.qlen_diff, cfg.n_alignment_diff, cfg)
    plain = jC.get_subgraphs(edges, node_pos)
    with jdispatch.use_mesh(jmesh.make_mesh(2)):
        meshed = jC.get_subgraphs(edges, node_pos)
    return edges, node_pos, plain, meshed


@pytest.mark.parametrize('case', ['mixed_mesh_2', 'three_edges_mesh_4'])
def test_get_subgraphs_under_a_mesh(mixed_graph, case, monkeypatch):
    """Under a CPU mesh, get_subgraphs merges its edge shards
    (merged_components is called) and gives the components of the call
    without a mesh; on the mixed scenario also fslr_tpu's under its mesh
    of 2.  Three edges over a mesh of 4 leave the last shard empty."""
    if case == 'mixed_mesh_2':
        edges, node_pos, want_plain, want_mesh = mixed_graph
        assert want_mesh == want_plain and len(want_plain) > 1
        n_dev = 2
    else:
        edges = [('a', 'b'), ('c', 'd'), ('b', 'e')]
        node_pos = {q: i for i, q in enumerate('abcde')}
        want_mesh = None
        n_dev = 4
    plain = tC.get_subgraphs(edges, node_pos, CPU)
    calls = []
    orig = tmerge.merged_components

    def spy(mesh, shards, n, cap):
        calls.append([len(s) for s in shards])
        return orig(mesh, shards, n, cap)

    monkeypatch.setattr(tmerge, 'merged_components', spy)
    with tdispatch.use_mesh(make_mesh(n_dev, 'cpu')):
        meshed = tC.get_subgraphs(edges, node_pos, CPU)
    per = -(-len(edges) // n_dev)
    assert calls == [[min(per, max(len(edges) - i * per, 0))
                      for i in range(n_dev)]]
    assert meshed == plain
    if want_mesh is not None:
        assert meshed == want_mesh
    else:
        assert plain == [{'a', 'b', 'e'}, {'c', 'd'}]
