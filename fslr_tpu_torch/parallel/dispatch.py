"""Data-parallel kernel calls over the active device mesh.

Counterpart of ``fslr_tpu/parallel/dispatch.py``.  Stages call their
kernels through :func:`dp_call`:

* no active mesh, or a mesh of one device (the default): the function
  runs as a plain call, with no overhead and the same launches;
* an active mesh: the batch (leading-axis) arguments are padded to a
  multiple of the mesh size by repeating their last row (every kernel
  here is row-independent, so a repeated row is wasted work, never a
  different answer) and cut into contiguous row shards, one per mesh
  entry; the calling thread runs the shards in mesh order, each with its
  device current (``torch.cuda.device``), the replicated tables taken
  from a per-device cache that uploads each table once per device; each
  output leaf is concatenated on the first mesh device along its batch
  axis and cut back to the batch's rows.

One thread queues every card's shard: kernel launches and torch
operations return before their card has run them, so the cards work side
by side while the thread moves on.  A host thread a card would only
contend for the interpreter's lock, which every torch operation takes
back: on four cards such threads ran the align stage's many small
operations five to ten times slower than one card did (four H100s,
chip_smoke.py phase 12), and four threads of one CPU device ran several
times slower than the same shards in turn.

The row math is the same however the rows are cut, so a sharded run's
artifacts equal a single-device run's.  Counters need no counterpart of
fslr_tpu's ``dp_sum``: they are host arrays here, summed by numpy.
"""

from __future__ import annotations

import contextlib
import threading
import weakref

import torch

from fslr_tpu_torch.parallel.mesh import Mesh, replicate, shard_reads

_ACTIVE: Mesh | None = None
_REPLICAS: dict = {}   # (id(table), mesh) -> (weakref(table), {device: copy})
_LOCK = threading.Lock()


def set_mesh(mesh: Mesh | None):
    """Make ``mesh`` the active mesh (None: plain calls)."""
    global _ACTIVE
    _ACTIVE = mesh
    with _LOCK:
        _REPLICAS.clear()


def active_mesh() -> Mesh | None:
    return _ACTIVE


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    prev = _ACTIVE
    set_mesh(mesh)
    try:
        yield
    finally:
        set_mesh(prev)


def sharded() -> bool:
    """True under an active mesh of several entries."""
    return _ACTIVE is not None and _ACTIVE.size > 1


def replicas(table: torch.Tensor | None) -> list:
    """``table`` on every device of the active mesh (see
    ``mesh.replicate``): the copies on other devices are made at the
    first call and kept while ``table`` lives; None stays None."""
    mesh = _ACTIVE
    if table is None:
        return [None] * mesh.size
    key = (id(table), mesh)
    with _LOCK:
        hit = _REPLICAS.get(key)
        if hit is not None and hit[0]() is table:
            others = hit[1]
        else:
            # the cache holds no reference to the table itself
            others = {d: c for d, c in zip(mesh.devices,
                                           replicate(mesh, table)[0])
                      if d != table.device}
            _REPLICAS[key] = (weakref.ref(
                table, lambda _, key=key: _REPLICAS.pop(key, None)), others)
    return [others.get(d, table) for d in mesh.devices]


def _pad_rows(a: torch.Tensor, n_to: int) -> torch.Tensor:
    """``a`` with its last row repeated up to ``n_to`` rows."""
    n = a.shape[0]
    if n == n_to:
        return a
    return torch.cat([a, a[-1:].expand(n_to - n, *a.shape[1:])])


def _on(device: torch.device, fn, args):
    """``fn(*args)`` with ``device`` current."""
    ctx = (torch.cuda.device(device) if device.type == 'cuda'
           else contextlib.nullcontext())
    with ctx:
        return fn(*args)


def _gather(outs: list, device: torch.device, n: int, dims):
    """One output tree from the shards' trees: every tensor leaf
    concatenated on ``device`` along its batch axis (``dims``: an int for
    every leaf, or a tuple that matches a tuple output) and cut to ``n``
    rows."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outs], dim=dims).narrow(
            dims, 0, n)
    if isinstance(first, dict):
        return {k: _gather([o[k] for o in outs], device, n, dims)
                for k in first}
    if isinstance(first, tuple):
        per = dims if isinstance(dims, tuple) else (dims,) * len(first)
        return tuple(_gather([o[i] for o in outs], device, n, per[i])
                     for i in range(len(first)))
    raise TypeError(f'dp_call: output leaf of type {type(first).__name__} '
                    'is not a tensor')


def dp_call(fn, batch_args, repl_args=(), statics=(), out_dims=0):
    """``fn(*batch_args, *repl_args, *statics)``, data-parallel over the
    active mesh (a plain call without one).

    ``batch_args`` are tensors that share their leading (row) axis;
    ``repl_args`` are tables every shard reads whole (tensors on the
    first mesh device, or None); ``statics`` are other values (configs,
    sizes).  ``out_dims`` names the batch axis of the output leaves: one
    int for all, or a tuple that matches a tuple output."""
    n = int(batch_args[0].shape[0])
    if not sharded() or n == 0:
        return fn(*batch_args, *repl_args, *statics)
    mesh = _ACTIVE
    n_to = -(-n // mesh.size) * mesh.size
    shards = shard_reads(mesh, *(_pad_rows(a, n_to) for a in batch_args))
    tables = [replicas(t) for t in repl_args]
    outs = [_on(d, fn, [s[i] for s in shards] + [t[i] for t in tables]
                + list(statics)) for i, d in enumerate(mesh.devices)]
    return _gather(outs, mesh.devices[0], n, out_dims)
