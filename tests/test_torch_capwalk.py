"""The port's scale path on capped frames, against fslr_tpu's device path.

Where a query reaches the soft edge cap, the scale path tests each pair at
its first encounter (ops/capwalk.py's closed form), while the host path
replays the reference's walk exactly; the two may differ on purpose
(ROADMAP.md section 3, "Large cluster frames").  So on the oracle's capped
frames (tests/test_reference_oracle.py: seeds 700-703, and the four seeds
where fslr_tpu's adversarial cap sweep found a partition that differs from
the reference walk) the port's cluster and representative beds, with its
entries on the device (in-HBM and sharded) and spilled to the host, must
be byte-equal to fslr_tpu's device path.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from fslr_tpu.config import ClusterConfig
from fslr_tpu.stages import cluster as jC
from fslr_tpu_torch.ops import encounters as tenc
from fslr_tpu_torch.stages import cluster as tC
from fslr_tpu_torch.stages import mapping_table
from tests.test_reference_oracle import make_frame
from tests.test_torch_env import port_config

CPU = torch.device('cpu')
CHR_LEN = {f'chr{c}': n for c, n in ((1, 10_000_000), (2, 10_000_000),
                                     (3, 3_000_000))}


def _oracle_frame(seed):
    rng = np.random.default_rng(seed)
    if seed >= 700:             # test_differential_capped_device_components
        return (make_frame(rng, n_groups=3, max_members=25, n_noise=4),
                ClusterConfig(device_enum_min_encounters=0))
    # test_cap_sweep_mismatch_seeds_host_exact
    bed = make_frame(rng, n_groups=int(rng.integers(1, 5)),
                     max_members=int(rng.integers(12, 40)),
                     n_noise=int(rng.integers(0, 10)))
    return bed, ClusterConfig(
        edge_threshold=int(rng.choice([3, 5, 10, 10, 10])),
        device_enum_min_encounters=0)


def _beds(res, tmp_path, tag, write):
    out = []
    for suffix, bed in (('.cluster.bed', res.cluster_bed),
                        ('.representative.bed', res.representative_bed)):
        p = str(tmp_path / f'{tag}{suffix}')
        write(bed, p)
        with open(p, 'rb') as fh:
            out.append(fh.read())
    return out


def _port_beds(path, cfg, tmp_path, tag):
    res = tC.cluster_stage(tC.read_mappings(path), CHR_LEN,
                           port_config(cfg), CPU)
    assert not res.no_clusters
    return _beds(res, tmp_path, tag, mapping_table.write_mappings_bed)


@pytest.mark.parametrize('seed', [700, 701, 702, 703, 20, 159, 183, 857])
def test_capped_frames_equal_fslr_tpu_device_path(tmp_path, seed,
                                                  monkeypatch):
    bed, cfg = _oracle_frame(seed)
    bed = bed.assign(chrom=[f'chr{c}' for c in bed['chrom']])
    path = str(tmp_path / 'S.mappings.bed')
    bed.to_csv(path, sep='\t', index=False)
    jres = jC.cluster_stage(pd.read_csv(path, sep='\t', engine='pyarrow'),
                            CHR_LEN, cfg)
    assert not jres.no_clusters
    want = _beds(jres, tmp_path, 'jax',
                 lambda b, p: b.to_csv(p, index=False, sep='\t'))
    assert _port_beds(path, cfg, tmp_path, 'in_hbm') == want
    past = dataclasses.replace(cfg, enum_spill_min_encounters=1)
    assert _port_beds(path, past, tmp_path, 'sharded') == want
    monkeypatch.setattr(tenc, 'SPILL_DIRECT_MIN', 0)
    assert _port_beds(path, past, tmp_path, 'spill') == want
    if seed < 700:
        # the exact walk of the host path gives another partition here
        host = dataclasses.replace(cfg, device_enum_min_encounters=1 << 62)
        assert _port_beds(path, host, tmp_path, 'host') != want
