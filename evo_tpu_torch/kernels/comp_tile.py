"""Contrast compensation's tile residual and its Jacobian as one CUDA kernel,
one block per tile row.

Counterpart of `evo_tpu/tracker/compensate.py::tile_residual` (with
`tile_edge_loss` or `tile_variance_loss`) under `jax.jacfwd` (XLA device
code: the JAX package has no Pallas kernel here). For each row (a tile of a
window) the kernel warps the row's events by its velocity, splats them with
the two tangent images, and carries the loss forward in dual numbers: r [R]
and J [R, 2] = dr/dv in one launch. The plain PyTorch version is
`tracker.compensate.tile_residual_and_jacobian_ref` (autograd), and
`tracker.compensate.tile_residual_and_jacobian` picks between the two by the
tensors' device.

The kernel is `csrc/comp_tile.cu`, built at first use by `kernels.nvcc` with
`-fmad=false`. It takes tensors on the card only and padded tiles of at most
`MAX_SIDE` px a side (20 px tiles: 60; 40 px tiles: 120); a CPU tensor
raises, as does a larger tile or a failed build or launch. A row's result
depends on that row's inputs alone.

`TileLaunch` checks its tensors once and packs the kernel's pointers once, so
the LM loop's launch at each trip is one ctypes call. Given `clocks` (int64
[R, len(STAGES)]), it launches the clock build instead (`-DEVO_COMP_CLOCKS`,
a library of its own, on no path of the program): the same outputs, and each
row's `clock64()` cycles by stage.
"""

from __future__ import annotations

import array
import ctypes
import threading

import torch

from evo_tpu_torch.kernels import nvcc

# the largest padded tile side the kernel holds in shared memory: the image
# and its two tangents of 120 x 120 floats beside the loss's strips
MAX_SIDE = 120
LOSSES = {"edge": 0, "variance": 1}

# Launches of the kernel since the last reset; the compensation worker and
# the main thread launch side by side, so the count changes under a lock.
launches_comp_tile = 0
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches_comp_tile
    with _count_lock:
        launches_comp_tile = 0


def _count() -> None:
    global launches_comp_tile
    with _count_lock:
        launches_comp_tile += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # pointers (`POINTERS`), R, E, side, rows_per_window, loss, scale, tile,
    # weight, sigma, radius, the blur's four taps, stream
    "evo_comp_tile": ([_P] + [_I] * 5 + [_F] * 9 + [_P], _I),
}
# the entry's pointer array, in the order of csrc/comp_tile.cu's `Args`
POINTERS = ("vel", "ex", "ey", "dt_us", "valid", "tlx", "tly", "active", "live",
            "r", "J", "escaped", "score", "clocks")
# stages of the clock build's [R, len(STAGES)] int64 output, in the kernel's
# order (csrc/comp_tile.cu's `Stage`)
STAGES = ("reach", "zero", "deposit", "copies", "escaped", "vertical", "horizontal", "pool",
          "reduce", "total")
_libs: dict = {}
_lib_lock = threading.Lock()


def _lib(clocks: bool = False):
    """The compiled kernel (built from csrc/comp_tile.cu at first use); with
    `clocks`, its clock build (-DEVO_COMP_CLOCKS), a library of its own."""
    with _lib_lock:
        if clocks not in _libs:
            name, flags = "evo_comp_tile", ("-fmad=false",)
            if clocks:
                name, flags = name + "_clock", flags + ("-DEVO_COMP_CLOCKS",)
            _libs[clocks] = nvcc.load(name, ["comp_tile.cu"], _SIGNATURES, extra_flags=flags)
        return _libs[clocks]


def _check(vel, events: dict, tile: int, loss: str, out: dict, live, rows_per_window: int):
    """Raise unless the tensors are what the kernel reads and writes: their
    types and shapes first, then the device (a tensor on the CPU raises)."""
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}")
    if not 5 <= 3 * tile <= MAX_SIDE:
        raise ValueError(f"a {tile} px tile pads to {3 * tile} px, outside the kernel's "
                         f"5 to {MAX_SIDE}")
    ex = events["ex"]
    if ex.dim() != 2:
        raise ValueError(f"ex must be [R, E], got {tuple(ex.shape)}")
    rows, e = ex.shape
    want = dict(vel=((rows, 2), torch.float32), ex=((rows, e), torch.float32),
                ey=((rows, e), torch.float32), dt_us=((rows, e), torch.float32),
                valid=((rows, e), torch.bool), tlx=((rows,), torch.float32),
                tly=((rows,), torch.float32), active=((rows,), torch.bool),
                r=((rows,), torch.float32), J=((rows, 2), torch.float32),
                escaped=((rows,), torch.bool), score=((rows,), torch.float32),
                clocks=((rows, len(STAGES)), torch.int64))
    named = {"vel": vel, **events, **out}
    if live is not None:
        if rows_per_window < 1 or rows % rows_per_window:
            raise ValueError(f"{rows} rows are not windows of {rows_per_window}")
        want["live"] = ((rows // rows_per_window,), torch.int32)
        named["live"] = live
    for name, t in named.items():
        if t is None:
            continue
        shape, dtype = want[name]
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, not {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != vel.device:
            raise ValueError(f"{name} is on {t.device}, not on {vel.device}")
    if vel.device.type != "cuda":
        raise RuntimeError(
            f"comp_tile has no kernel for device {vel.device}: the plain version is "
            "tracker.compensate.tile_residual_and_jacobian_ref (tracker.compensate."
            "tile_residual_and_jacobian picks it for tensors on the CPU)")


def pack(vel, events: dict, *, tile: int, scale: float, loss: str, weight: float,
         sigma: float, radius: float, blur, r, J, escaped=None, score=None, live=None,
         rows_per_window: int = 1, clocks=None) -> tuple:
    """The C entry's arguments but the stream, its pointer array first:
    (the array, which must outlive the launch, and the argument tuple)."""
    named = {"vel": vel, **events, "live": live, "r": r, "J": J, "escaped": escaped,
             "score": score, "clocks": clocks}
    ptrs = array.array("Q", [0 if named[n] is None else named[n].data_ptr() for n in POINTERS])
    rows, e = events["ex"].shape
    return ptrs, (ptrs.buffer_info()[0], rows, e, 3 * tile, rows_per_window, LOSSES[loss],
                  float(scale), float(tile), float(weight), float(sigma), float(radius),
                  *(float(b) for b in blur))


class TileLaunch:
    """The kernel's launch over fixed tensors: vel [R, 2]; the events ex, ey,
    dt_us float32 and valid bool [R, E]; tlx, tly float32 and active bool
    [R]; into r [R] and J [R, 2] (and, when given, escaped [R] bool and the
    score [R], the loss that r = MAX_RES - score holds to 6e-5 alone). With
    `live` (int32 [R / rows_per_window], nonzero: the window iterates), the
    rows of the other windows are left unwritten. `blur` holds the structure
    tensor's blur taps at distance 0..3. The checks run here, before any
    build; `launch()` queues one launch on the current stream. With `clocks`
    (int64 [R, len(STAGES)]) it is the clock build's launch."""

    def __init__(self, vel, events: dict, *, tile: int, scale: float, loss: str,
                 weight: float, sigma: float, radius: float, blur, r, J, escaped=None,
                 score=None, live=None, rows_per_window: int = 1, clocks=None):
        _check(vel, events, tile, loss, dict(r=r, J=J, escaped=escaped, score=score,
                                             clocks=clocks), live, rows_per_window)
        # the tensors stay alive as long as the launch does
        self._keep = (vel, events, r, J, escaped, score, live, clocks)
        self._ptrs, self._args = pack(
            vel, events, tile=tile, scale=scale, loss=loss, weight=weight, sigma=sigma,
            radius=radius, blur=blur, r=r, J=J, escaped=escaped, score=score, live=live,
            rows_per_window=rows_per_window, clocks=clocks)
        self._on = vel
        self._fn = _lib(clocks is not None).evo_comp_tile

    def launch(self) -> None:
        nvcc.launch(self._fn, self._on, *self._args)
        _count()
