"""Build CUDA sources of the package into shared libraries at first use.

Each library is compiled by `nvcc` for `sm_90a` with a plain C interface and
loaded with ctypes; no PyTorch headers are involved, so a build takes
seconds. Libraries land in `evo_tpu_torch/_build/` under a source-hash name
(`core.build`). A build that fails raises: there is no other way to run a
kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from evo_tpu_torch.core import build

CSRC_DIR = os.path.join(build.PKG_DIR, "csrc")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
# compiler output of each build made by this process (ptxas register and
# shared-memory report), by library name
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def load(name: str, sources: list[str], signatures: dict,
         extra_flags: tuple[str, ...] = (), headers: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Return the loaded library built from `sources` (file names under
    `csrc/`) with `FLAGS` and `extra_flags`, compiling it first if needed;
    `headers` (file names under `csrc/`) are the ones the sources include,
    so that an edited header builds anew. `signatures` maps each exported
    function to (argtypes, restype)."""
    with _lock:  # one build of each library; two libraries build side by side
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        paths = [os.path.join(CSRC_DIR, s) for s in sources]
        so, log = build.shared_library(name, paths, [_nvcc(), *FLAGS, *extra_flags],
                                       headers=tuple(os.path.join(CSRC_DIR, h) for h in headers))
        if log is not None:
            build_logs[name] = log
        lib = ctypes.CDLL(so)
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
        return lib


def launch(fn, on, *args) -> None:
    """Call the C entry `fn` of a loaded library with `args` and PyTorch's
    current stream, on the card that holds the tensor `on`; raise if it
    returns a CUDA error (a launch that was refused never runs). The stream
    is read as a raw handle: one host call, where `torch.cuda.current_stream`
    builds a `Stream` object first."""
    dev = on.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: launch failed with CUDA error {err}")


def pointer(t, name: str, dtype, shape, dev) -> int:
    """The address of tensor `t` (called `name` in the error) after the
    checks a kernel's entry needs: `dtype`, `shape`, contiguous, on `dev`."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
            or t.device != dev:
        raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} on {dev}, got "
                         f"{t.dtype} {list(t.shape)} on {t.device}")
    return t.data_ptr()
