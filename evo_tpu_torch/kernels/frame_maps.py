"""A frame's maps — the log/Sobel gradient pair, the Harris response and
levels 1 and 2 of the Gaussian pyramid — as one CUDA kernel.

Counterpart of `evo_tpu/kernels/gradients.py::sobel` of `log_image`,
`evo_tpu/kernels/harris.py::harris_response` and
`gradients.py::image_pyramid` (XLA convolutions: the JAX package has no
Pallas kernel here). The kernel is `csrc/frame_maps.cu`, built at first use
by `kernels.nvcc` with `-fmad=false`; its plain PyTorch version is
`frame_maps_ref`, the conv2d chains the tracker ran before. `frame_maps`
takes the kernel for an image on the card (a failed build or launch raises)
and the plain version for an image on the CPU.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from evo_tpu_torch.kernels import gradients, nvcc

# the pyramid's blur (`gradients.image_pyramid`)
SIGMA, RADIUS = 1.0, 2
LEVELS = 3  # level 0 (the image) and the two the kernel writes

# Launches of the kernel since the last reset
launches_frame_maps = 0
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches_frame_maps
    with _count_lock:
        launches_frame_maps = 0


def _count() -> None:
    global launches_frame_maps
    with _count_lock:
        launches_frame_maps += 1


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # image, gauss, grad, resp, lvl1, lvl2, H, W, stream
    "evo_frame_maps": ([_P] * 6 + [_I, _I, _P], _I),
}
_libs: dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
_taps: dict = {}


def _lib():
    """The compiled kernel (built from csrc/frame_maps.cu at first use)."""
    with _lib_lock:
        if "lib" not in _libs:
            _libs["lib"] = nvcc.load("evo_frame_maps", ["frame_maps.cu"], _SIGNATURES,
                                     extra_flags=("-fmad=false",))
        return _libs["lib"]


def level_shapes(h: int, w: int) -> list:
    """[(h, w)] of the pyramid's levels 0, 1, 2 ([::2] keeps ceil(n / 2))."""
    shapes = [(h, w)]
    for _ in range(LEVELS - 1):
        h, w = (h + 1) // 2, (w + 1) // 2
        shapes.append((h, w))
    return shapes


def gradient_pair(img):
    """Log-image + Sobel/8 gradient pair of img [H, W], channel-major
    [2, H, W] (the plain version of the kernel's first map)."""
    gx, gy = gradients.sobel(gradients.log_image(img), scale=1.0 / 8.0)
    return torch.stack([gx, gy], dim=0)


def frame_maps_ref(img, block_size: int = 3):
    """Plain version: (grad [2, H, W], resp [H, W], level 1, level 2) of the
    image [H, W] float32, the response's box `block_size` wide."""
    from evo_tpu_torch.kernels import harris

    pyr = gradients.image_pyramid(img, LEVELS)
    return gradient_pair(img), harris.harris_response(img, block_size), pyr[1], pyr[2]


def _gauss(dev):
    """The blur's 5 taps on `dev`, made by the plain version's own code."""
    t = _taps.get(dev)
    if t is None:
        t = _taps.setdefault(dev, gradients.gaussian_kernel1d(SIGMA, RADIUS, device=dev)
                             .contiguous())
    return t


def run(fn, img, launch):
    """Allocate the outputs in one tensor and `launch(fn, image, gauss, grad,
    resp, lvl1, lvl2, H, W)` (the C entry's arguments without the stream).
    Returns (grad, resp, lvl1, lvl2)."""
    h, w = img.shape
    shapes = [(2, h, w), (h, w), *level_shapes(h, w)[1:]]
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    out = torch.empty(sum(sizes), dtype=torch.float32, device=img.device)
    parts = [p.view(s) for p, s in zip(out.split(sizes), shapes)]
    launch(fn, img.data_ptr(), _gauss(img.device).data_ptr(),
           *[p.data_ptr() for p in parts], h, w)
    return tuple(parts)


def frame_maps(img, block_size: int = 3):
    """(grad [2, H, W], resp [H, W], level 1, level 2) of the image [H, W]
    float32: one kernel launch for an image on the card (the response's box
    3 wide only), the plain version on the CPU (any `block_size`)."""
    if img.device.type == "cpu":
        return frame_maps_ref(img, block_size)
    if img.device.type != "cuda":
        raise RuntimeError(f"frame_maps has no kernel for device {img.device}")
    if block_size != 3:
        raise ValueError(f"the frame_maps kernel sums the response over a 3x3 box, not "
                         f"{block_size}x{block_size}")
    if img.dim() != 2 or img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError(f"frame_maps takes a contiguous float32 [H, W] image, got "
                         f"{img.dtype} {tuple(img.shape)}")
    outs = run(_lib().evo_frame_maps, img, lambda fn, *args: nvcc.launch(fn, img, *args))
    _count()
    return outs


def pyramid(img, maps, levels: int) -> tuple:
    """The frame's pyramid (level 0 the image) from its maps, `levels` deep;
    on the CPU, deeper than the maps by the plain version."""
    if levels > LEVELS:
        if img.device.type == "cpu":
            return tuple(gradients.image_pyramid(img, levels))
        raise ValueError(f"the frame's maps hold {LEVELS} pyramid levels, not {levels}")
    return (img, maps[2], maps[3])[:levels]

