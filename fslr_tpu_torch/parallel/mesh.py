"""The device mesh: the ``torch.device``s that data-parallel calls spread
their rows over (counterpart of ``fslr_tpu/parallel/mesh.py``, which
builds a 1-D JAX mesh).

A mesh is a tuple of devices; a device may appear more than once (two
entries on one card run two shards on it).  ``shard_reads`` cuts a batch
into contiguous row shards, one per entry; ``replicate`` puts a whole
table on every entry.
"""

from __future__ import annotations

import dataclasses

import torch


def canonical(device) -> torch.device:
    """``device`` as a tensor on it reports it: a CUDA device without an
    index is the current card."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a 1-D data mesh over reads."""
    devices: tuple

    def __post_init__(self):
        devs = tuple(canonical(d) for d in self.devices)
        if not devs:
            raise ValueError('a mesh needs at least one device')
        object.__setattr__(self, 'devices', devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None,
              device_type: str = 'cuda') -> Mesh:
    """A mesh of the visible cards (the first ``n_devices`` of them), or
    for ``device_type='cpu'`` of ``n_devices`` CPU entries (default 1)."""
    if device_type == 'cpu':
        return Mesh((torch.device('cpu'),) * (n_devices or 1))
    if device_type != 'cuda':
        raise ValueError(f'unsupported device type {device_type!r}')
    devs = [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    if not devs:
        raise RuntimeError('make_mesh: no CUDA card is visible')
    return Mesh(tuple(devs[:n_devices] if n_devices else devs))


def shard_reads(mesh: Mesh, *arrays) -> list[list[torch.Tensor]]:
    """For each array, its contiguous row shards (ceil(n / size) rows,
    the last ones shorter), each a fresh copy on its mesh entry."""
    out = []
    for a in arrays:
        per = -(-a.shape[0] // mesh.size)
        out.append([a[i * per:(i + 1) * per].to(d, copy=True)
                    for i, d in enumerate(mesh.devices)])
    return out


def replicate(mesh: Mesh, *arrays) -> list[list[torch.Tensor]]:
    """For each array, one tensor per mesh entry: the array itself on its
    own device, one copy on each other device (an entry that repeats a
    device shares that device's tensor)."""
    out = []
    for a in arrays:
        on = {a.device: a}
        for d in mesh.devices:
            if d not in on:
                on[d] = a.to(d)
        out.append([on[d] for d in mesh.devices])
    return out
