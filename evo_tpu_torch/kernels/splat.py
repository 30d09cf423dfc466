"""Event splatting: weighted events accumulated into images.

Counterpart of `evo_tpu/kernels/splat.py::splat_image` and of the TPU kernel
`evo_tpu/kernels/splat_pallas.py::splat_image_pallas`. Every stamp used here
is separable, `img[h, w] = sum_e w_e * k(h - y_e) * k(w - x_e)`, with `k` the
nearest (|d| <= 0.5, so an event exactly at k + 0.5 lands on both
neighbours), bilinear (max(0, 1 - |d|)) or truncated Gaussian
(exp(-(d / sigma)^2 / 2) where |d| <= radius) tap.

Two entry points, each with a plain PyTorch version beside it:

- `splat_image(x, y, weight, H, W)`: the generic splat, differentiable with
  respect to x, y and the weights. Plain versions `splat_image_ref` (the
  dense-tap form of the JAX package, `Y^T @ X` over [N, H] and [N, W] tap
  matrices) and `splat_bwd_ref`.
- `warp_splat(vel, ex, ey, dt_us, valid, tlx, tly, ...)`: the compensation
  tile splat with its warp fused in. Events of tile t move by
  `dt_us * scale * vel[t]` into the tile's padded frame and are splatted
  there; it is differentiable with respect to `vel` alone, and its
  backward returns d/d vel [T, 2] directly. Plain version `warp_splat_ref`
  (the elementwise warp, then `splat_image_ref`, and autograd through both).

The CUDA kernels are in `csrc/splat.cu`, built at first use by
`kernels.nvcc`. Dispatch on the image size (not on failure): an image of at
most `TILE_PIXELS` pixels is accumulated by one block in shared memory
(private copies, no atomics), a larger one by one thread per event with
global atomics. A tensor on the CPU takes the plain version; a tensor on the
card takes the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

MODES = {"nearest": 0, "bilinear": 1, "gaussian": 2}

# An image of at most this many pixels (16 KB) is accumulated in shared
# memory by one block, in several private copies (eleven of this size fit
# beside the staging arrays); a larger one goes to the many-block kernels.
TILE_PIXELS = 4096
# Threads of a one-block-per-image kernel, and private copies of the image in
# its shared memory, one per depositing warp (0: as many as fit beside the
# staging arrays, 12 for a 60x60 image). The sweep in PERF.md found these
# fastest at [108, 256] and [108, 1024].
TILE_THREADS = 1024
TILE_COPIES = 0

# Launches of each CUDA kernel since the last reset: the generic splat's
# forward and backward, and the fused warp-and-splat's. Threads launch side
# by side (the compensation worker beside the main thread), so the counts
# change under a lock.
launches_fwd = 0
launches_bwd = 0
launches_warp_fwd = 0
launches_warp_bwd = 0
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches_fwd, launches_bwd, launches_warp_fwd, launches_warp_bwd
    with _count_lock:
        launches_fwd = 0
        launches_bwd = 0
        launches_warp_fwd = 0
        launches_warp_bwd = 0


def _count(name: str) -> None:
    with _count_lock:
        globals()[name] += 1


def _taps(coord, size: int, mode: str, sigma: float, radius: int):
    """Dense tap matrix [..., N, size] and its derivative with respect to the
    coordinate, for coord [..., N]."""
    grid = torch.arange(size, dtype=coord.dtype, device=coord.device)
    d = grid - coord[..., None]
    ad = d.abs()
    zero = torch.zeros((), dtype=coord.dtype, device=coord.device)
    if mode == "nearest":
        k = (ad <= 0.5).to(coord.dtype)
        return k, torch.zeros_like(k)
    if mode == "bilinear":
        return (1.0 - ad).clamp_min(0.0), torch.where(ad < 1.0, torch.sign(d), zero)
    if mode == "gaussian":
        inside = ad <= radius
        g = torch.exp(-0.5 * (d / sigma) ** 2)
        k = torch.where(inside, g, zero)
        return k, torch.where(inside, g * (d / sigma) / sigma, zero)
    raise ValueError(mode)


def splat_image_ref(x, y, weight, height: int, width: int, *,
                    mode: str = "bilinear", sigma: float = 1.0,
                    radius: int = 3):
    """Plain version: x, y, weight [N] or [B, N] -> image [H, W] or
    [B, H, W], as the dense tap contraction of `evo_tpu.kernels.splat`."""
    ytap, _ = _taps(y, height, mode, sigma, radius)
    xtap, _ = _taps(x, width, mode, sigma, radius)
    ytap = ytap * weight[..., None]
    return ytap.transpose(-1, -2) @ xtap


def splat_bwd_ref(x, y, weight, grad_out, height: int, width: int, *,
                  mode: str = "bilinear", sigma: float = 1.0,
                  radius: int = 3):
    """Plain version of the backward: (d/dx, d/dy, d/dweight) of
    sum(grad_out * splat_image(x, y, weight)), each shaped like x."""
    ky, dky = _taps(y, height, mode, sigma, radius)
    kx, dkx = _taps(x, width, mode, sigma, radius)
    rows = ky @ grad_out  # [..., N, W]: the upstream gradient at each event's row taps
    gw = (rows * kx).sum(-1)
    gx = weight * (rows * dkx).sum(-1)
    gy = weight * ((dky @ grad_out) * kx).sum(-1)
    return gx, gy, gw


def _warp_events(vel, ex, ey, dt_us, valid, tlx, tly, scale, tile, weight):
    """(px, py, w) [T, E]: the warp of
    `evo_tpu/tracker/compensate.py::tile_residual`, in its order of
    operations."""
    shift = dt_us * scale
    px = ex + shift * vel[:, 0:1] - tlx[:, None] + tile
    py = ey + shift * vel[:, 1:2] - tly[:, None] + tile
    w = torch.where(valid, weight, 0.0).to(torch.float32)
    return px, py, w


def warp_splat_ref(vel, ex, ey, dt_us, valid, tlx, tly, *, scale: float,
                   tile: int, weight: float, mode: str = "gaussian",
                   sigma: float = 1.0, radius: int = 3):
    """Plain version of `warp_splat`: the elementwise warp, then
    `splat_image_ref`. Differentiable by autograd."""
    px, py, w = _warp_events(vel, ex, ey, dt_us, valid, tlx, tly, scale, tile, weight)
    return splat_image_ref(px, py, w, 3 * tile, 3 * tile, mode=mode,
                           sigma=sigma, radius=radius)


def _check_events(named, shape_of):
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != shape_of.device:
            raise ValueError(f"{name} is on {t.device}, not on {shape_of.device}")


def _check(x, y, weight, height: int, width: int, mode: str):
    if mode not in MODES:
        raise ValueError(f"unknown splat mode {mode!r}")
    if x.dim() not in (1, 2) or x.shape != y.shape or x.shape != weight.shape:
        raise ValueError(
            f"x, y, weight must share one shape [N] or [B, N]; got "
            f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(weight.shape)}"
        )
    _check_events((("x", x), ("y", y), ("weight", weight)), x)
    if height <= 0 or width <= 0:
        raise ValueError(f"image size {height}x{width}")


def _check_warp(vel, ex, ey, dt_us, valid, tlx, tly, tile: int, mode: str):
    if mode not in MODES:
        raise ValueError(f"unknown splat mode {mode!r}")
    if ex.dim() != 2 or ey.shape != ex.shape or dt_us.shape != ex.shape \
            or valid.shape != ex.shape:
        raise ValueError(
            f"ex, ey, dt_us, valid must share one shape [T, E]; got "
            f"{tuple(ex.shape)}, {tuple(ey.shape)}, {tuple(dt_us.shape)}, "
            f"{tuple(valid.shape)}"
        )
    t = ex.shape[0]
    if vel.shape != (t, 2) or tlx.shape != (t,) or tly.shape != (t,):
        raise ValueError(
            f"vel must be [{t}, 2] and tlx, tly [{t}]; got {tuple(vel.shape)}, "
            f"{tuple(tlx.shape)}, {tuple(tly.shape)}"
        )
    _check_events((("vel", vel), ("ex", ex), ("ey", ey), ("dt_us", dt_us),
                   ("tlx", tlx), ("tly", tly)), ex)
    if valid.dtype != torch.bool or not valid.is_contiguous() \
            or valid.device != ex.device:
        raise ValueError("valid must be a contiguous bool tensor on the events' device")
    if tile <= 0:
        raise ValueError(f"tile {tile}")


def _check_kernel_takes(x, mode: str, radius):
    """What only the CUDA kernels restrict."""
    if x.device.type != "cuda":
        raise RuntimeError(f"splat has no kernel for device {x.device}")
    if mode == "gaussian" and not 0 < radius <= 3:
        raise ValueError(
            f"the kernel holds eight candidate taps an axis: radius {radius} > 3")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, y, w, out, B, N, H, W, mode, sigma, radius, copies, threads, stream
    "evo_splat_tile_fwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P], _I),
    # x, y, w, out, B, N, H, W, mode, sigma, radius, stream
    "evo_splat_global_fwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P], _I),
    # x, y, w, grad_out, gx, gy, gw, B, N, H, W, mode, sigma, radius, threads, stream
    "evo_splat_tile_bwd": ([_P] * 7 + [_I, _I, _I, _I, _I, _F, _F, _I, _P], _I),
    # x, y, w, grad_out, gx, gy, gw, B, N, H, W, mode, sigma, radius, stream
    "evo_splat_global_bwd": ([_P] * 7 + [_I, _I, _I, _I, _I, _F, _F, _P], _I),
    # ex, ey, dt_us, valid, vel, tlx, tly, scale, tile, weight, out, T, E, side,
    # mode, sigma, radius, copies, threads, stream
    "evo_warp_splat_fwd": ([_P] * 7 + [_F, _F, _F, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P], _I),
    # ex, ey, dt_us, valid, vel, tlx, tly, scale, tile, weight, grad_out, gvel,
    # T, E, side, mode, sigma, radius, threads, stream
    "evo_warp_splat_bwd": ([_P] * 7 + [_F, _F, _F, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P], _I),
    # n, stream
    "evo_empty_launches": ([_I, _P], _I),
}
_lib_handle = None
_lib_lock = threading.Lock()


def _lib():
    """The compiled kernels (built from csrc/splat.cu at first use)."""
    global _lib_handle
    with _lib_lock:  # one build, whichever thread launches first
        if _lib_handle is None:
            from evo_tpu_torch.kernels import nvcc

            _lib_handle = nvcc.load("evo_splat", ["splat.cu"], _SIGNATURES)
    return _lib_handle


def _launch(name: str, on, *args) -> None:
    """Call the C entry `name` with `args` and PyTorch's current stream, on
    the card that holds the tensor `on`; raise if the launch was refused."""
    from evo_tpu_torch.kernels import nvcc

    nvcc.launch(getattr(_lib(), name), on, *args)


def _bn(x):
    return (1, x.shape[0]) if x.dim() == 1 else tuple(x.shape)


def _forward(x, y, weight, height, width, mode, sigma, radius,
             copies: int = TILE_COPIES, threads: int = TILE_THREADS):
    if x.device.type == "cpu":
        return splat_image_ref(x, y, weight, height, width, mode=mode,
                               sigma=sigma, radius=radius)
    _check_kernel_takes(x, mode, radius)
    b, n = _bn(x)
    out = torch.empty(x.shape[:-1] + (height, width), dtype=torch.float32,
                      device=x.device)
    args = (x.data_ptr(), y.data_ptr(), weight.data_ptr(), out.data_ptr(),
            b, n, height, width, MODES[mode], float(sigma), float(radius))
    if height * width <= TILE_PIXELS:
        _launch("evo_splat_tile_fwd", x, *args, copies, threads)
    else:
        _launch("evo_splat_global_fwd", x, *args)
    _count("launches_fwd")
    return out


def _backward(x, y, weight, grad_out, height, width, mode, sigma, radius,
              threads: int = TILE_THREADS):
    if x.device.type == "cpu":
        return splat_bwd_ref(x, y, weight, grad_out, height, width, mode=mode,
                             sigma=sigma, radius=radius)
    _check_kernel_takes(x, mode, radius)
    b, n = _bn(x)
    gx = torch.empty_like(x)
    gy = torch.empty_like(x)
    gw = torch.empty_like(x)
    args = (x.data_ptr(), y.data_ptr(), weight.data_ptr(), grad_out.data_ptr(),
            gx.data_ptr(), gy.data_ptr(), gw.data_ptr(),
            b, n, height, width, MODES[mode], float(sigma), float(radius))
    if height * width <= TILE_PIXELS:
        _launch("evo_splat_tile_bwd", x, *args, threads)
    else:
        _launch("evo_splat_global_bwd", x, *args)
    _count("launches_bwd")
    return gx, gy, gw


class _Splat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, weight, height, width, mode, sigma, radius):
        ctx.save_for_backward(x, y, weight)
        ctx.cfg = (height, width, mode, sigma, radius)
        return _forward(x, y, weight, height, width, mode, sigma, radius)

    @staticmethod
    def backward(ctx, grad_out):
        x, y, weight = ctx.saved_tensors
        gx, gy, gw = _backward(x, y, weight, grad_out.contiguous(), *ctx.cfg)
        return gx, gy, gw, None, None, None, None, None


def splat_image(x, y, weight, height: int, width: int, *,
                mode: str = "bilinear", sigma: float = 1.0, radius: int = 3):
    """Accumulate events into an image.

    x, y, weight: float32 [N] or [B, N], contiguous, on one device (weight 0
    masks padding out). Returns [H, W] or [B, H, W] float32. Differentiable
    with respect to all three inputs. On the card an image of at most
    `TILE_PIXELS` pixels takes the one-block-per-image kernels (shared-memory
    accumulation), a larger one the one-thread-per-event kernels.
    """
    _check(x, y, weight, height, width, mode)
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad
                                    or weight.requires_grad):
        return _Splat.apply(x, y, weight, height, width, mode, sigma, radius)
    return _forward(x, y, weight, height, width, mode, sigma, radius)


def _warp_forward(vel, events, cfg, copies: int = TILE_COPIES,
                  threads: int = TILE_THREADS):
    """events = (ex, ey, dt_us, valid, tlx, tly); cfg = (scale, tile, weight,
    mode, sigma, radius). Launches the fused forward: [T, 3 tile, 3 tile]."""
    ex, ey, dt_us, valid, tlx, tly = events
    scale, tile, weight, mode, sigma, radius = cfg
    t, e = ex.shape
    side = 3 * tile
    out = torch.empty((t, side, side), dtype=torch.float32, device=ex.device)
    _launch("evo_warp_splat_fwd", ex,
            ex.data_ptr(), ey.data_ptr(), dt_us.data_ptr(), valid.data_ptr(),
            vel.data_ptr(), tlx.data_ptr(), tly.data_ptr(),
            float(scale), float(tile), float(weight), out.data_ptr(),
            t, e, side, MODES[mode], float(sigma), float(radius), copies, threads)
    _count("launches_warp_fwd")
    return out


def _warp_backward(vel, events, cfg, grad_out, threads: int = TILE_THREADS):
    """Launches the fused backward: d sum(grad_out * image) / d vel [T, 2]."""
    ex, ey, dt_us, valid, tlx, tly = events
    scale, tile, weight, mode, sigma, radius = cfg
    t, e = ex.shape
    gvel = torch.empty((t, 2), dtype=torch.float32, device=ex.device)
    _launch("evo_warp_splat_bwd", ex,
            ex.data_ptr(), ey.data_ptr(), dt_us.data_ptr(), valid.data_ptr(),
            vel.data_ptr(), tlx.data_ptr(), tly.data_ptr(),
            float(scale), float(tile), float(weight), grad_out.data_ptr(),
            gvel.data_ptr(), t, e, 3 * tile, MODES[mode], float(sigma), float(radius),
            threads)
    _count("launches_warp_bwd")
    return gvel


class _WarpSplat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vel, events, cfg):
        ctx.save_for_backward(vel)
        ctx.events, ctx.cfg = events, cfg
        return _warp_forward(vel, events, cfg)

    @staticmethod
    def backward(ctx, grad_out):
        (vel,) = ctx.saved_tensors
        return _warp_backward(vel, ctx.events, ctx.cfg, grad_out.contiguous()), None, None


def warp_splat(vel, ex, ey, dt_us, valid, tlx, tly, *, scale: float, tile: int,
               weight: float, mode: str = "gaussian", sigma: float = 1.0,
               radius: int = 3):
    """Warp each tile's events by its velocity and splat them (compensation
    uses Gaussians).

    vel [T, 2]; ex, ey, dt_us float32 [T, E] and valid bool [T, E] (padding
    False); tlx, tly [T] the tiles' origins. An event lands at
    `ex + dt_us * scale * vel[t, 0] - tlx[t] + tile` (and likewise in y) of
    its tile's [3 tile, 3 tile] padded image with weight `weight`. Returns
    [T, 3 tile, 3 tile], differentiable with respect to `vel` only.

    On the card a padded image of at most `TILE_PIXELS` pixels takes the
    fused kernels; a larger one (a dispatch on size) is warped by elementwise
    PyTorch and splatted by the generic kernels of `splat_image`.
    """
    _check_warp(vel, ex, ey, dt_us, valid, tlx, tly, tile, mode)
    side = 3 * tile
    if ex.device.type == "cpu":
        return warp_splat_ref(vel, ex, ey, dt_us, valid, tlx, tly, scale=scale,
                              tile=tile, weight=weight, mode=mode, sigma=sigma,
                              radius=radius)
    if side * side > TILE_PIXELS:
        px, py, w = _warp_events(vel, ex, ey, dt_us, valid, tlx, tly, scale, tile, weight)
        return splat_image(px.contiguous(), py.contiguous(), w, side, side,
                           mode=mode, sigma=sigma, radius=radius)
    _check_kernel_takes(ex, mode, radius)
    events = (ex, ey, dt_us, valid, tlx, tly)
    cfg = (scale, tile, weight, mode, sigma, radius)
    if torch.is_grad_enabled() and vel.requires_grad:
        return _WarpSplat.apply(vel, events, cfg)
    return _warp_forward(vel.detach(), events, cfg)
