"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into one shared library with a plain C interface,
placed in ``fslr_tpu_torch/_build/`` under a name that hashes the sources
and flags, so a changed source rebuilds and an unchanged one loads at
once.  The
library is bound with ``ctypes``: every pointer and the stream pass as
``c_void_p``.  Each C entry point launches on the caller's stream and
returns ``cudaGetLastError()``; :meth:`Kernel.launch` runs it with the
arguments' device current, raises if it returns not 0 and counts the
launch.

Nothing here runs at import time: importing the package needs neither
``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         '_build')
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
COMPILE_FLAGS = ARCH_FLAGS + ('-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                              '-c')
LINK_FLAGS = ARCH_FLAGS + ('-shared',)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()   # launches come from several host threads


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(('.cu', '.cuh')))


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (PATH or /usr/local/cuda/bin)')


def library_path() -> str:
    """Path of the built library for the current sources (not built)."""
    h = hashlib.sha256(' '.join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, 'rb') as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f'libfslr_kernels_{h.hexdigest()[:16]}.so')


def build() -> str:
    """Compile ``csrc/*.cu`` into one shared library unless a build of the
    same sources exists; returns its path."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{so}.{os.getpid()}.tmp'
    cu = [p for p in _sources() if p.endswith('.cu')]
    objs = [f'{tmp}.{os.path.basename(p)}.o' for p in cu]
    nvcc = _nvcc()
    procs = []
    try:
        for src, obj in zip(cu, objs):
            procs.append(subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, '-o', obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        errors = []
        for src, proc in zip(cu, procs):
            _, err = proc.communicate()
            if proc.returncode:
                errors.append(f'{os.path.basename(src)} '
                              f'({proc.returncode}):\n{err}')
        if errors:
            raise RuntimeError('nvcc failed: ' + '\n'.join(errors))
        res = subprocess.run([nvcc, *LINK_FLAGS, '-o', tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f'nvcc link failed ({res.returncode}):\n'
                               f'{res.stderr}')
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for k in ALL:
                fn = getattr(lib, k.symbol)
                fn.argtypes = list(k.argtypes) + [_P]      # + stream
                fn.restype = ctypes.c_int
            lib.fslr_error_string.argtypes = [ctypes.c_int]
            lib.fslr_error_string.restype = ctypes.c_char_p
            lib.fslr_mask_scratch.argtypes = [ctypes.c_int]
            lib.fslr_mask_scratch.restype = ctypes.c_int
            _lib = lib
    return _lib


def mask_scratch_floats(L: int) -> int:
    """Floats of checkpoint scratch mask_kernel needs per read of length
    ``L`` (the kernel's own memory plan, csrc/tantan.cu)."""
    return library().fslr_mask_scratch(L)


class Kernel:
    """One CUDA entry point of the library and the number of times it was
    launched in this process, in all and on each card."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = tuple(argtypes)
        self.launches = 0
        self.by_device: dict[int, int] = {}

    def launch(self, *args):
        """Call the entry with ``args`` (tensors pass as their data
        pointers) on the device that holds the first tensor argument: its
        C entry runs with that device current, on that device's current
        stream, whichever device the calling thread had current."""
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        lib = library()
        with torch.cuda.device(dev):
            rc = getattr(lib, self.symbol)(
                *ptrs, torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            msg = lib.fslr_error_string(rc).decode()
            raise RuntimeError(f'{self.name} launch failed: CUDA error '
                               f'{rc} ({msg})')
        with _count_lock:
            self.launches += 1
            self.by_device[dev.index] = self.by_device.get(dev.index, 0) + 1


MASK = Kernel('mask_kernel', 'fslr_mask',
              (_P, _I, _I, _I, _P, _F, _F, _F, _F, _F, _P, _P))
SW_PACKED = Kernel('sw_packed_kernel', 'fslr_sw_packed',
                   (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P))
SW = Kernel('sw_kernel', 'fslr_sw',
            (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P))
BANDED = Kernel('banded_kernel', 'fslr_banded',
                (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I))
TB = Kernel('tb_kernel', 'fslr_tb',
            (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I))
WALK = Kernel('walk_kernel', 'fslr_walk', (_P, _P, _P, _P, _I, _I, _P, _P))
PROF = Kernel('prof_kernel', 'fslr_prof',
              (_P, _P, _P, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P))
ALL = (MASK, SW_PACKED, SW, BANDED, TB, WALK, PROF)


def reset_launches():
    with _count_lock:
        for k in ALL:
            k.launches = 0
            k.by_device = {}


def launch_counts(by_device: bool = False) -> dict:
    """{kernel: launches}, or with ``by_device`` {kernel: {card index:
    launches}} (the cards it launched on)."""
    with _count_lock:
        if by_device:
            return {k.name: dict(k.by_device) for k in ALL}
        return {k.name: k.launches for k in ALL}


def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if x.device.type == 'cuda':
        return True
    if x.device.type == 'cpu':
        return False
    raise ValueError(f'unsupported device {x.device}')


def check(x: torch.Tensor, name: str, dtype, shape, device):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (the contract of every kernel argument)."""
    if x.device != device:
        raise ValueError(f'{name}: on {x.device}, expected {device}')
    if x.dtype != dtype:
        raise ValueError(f'{name}: dtype {x.dtype}, expected {dtype}')
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(x.shape)}, expected '
                         f'{tuple(shape)}')
    if not x.is_contiguous():
        raise ValueError(f'{name}: not contiguous')
