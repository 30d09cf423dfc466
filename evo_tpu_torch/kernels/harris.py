"""Harris corner detection with NMS, quality filtering and min-distance
selection — counterpart of `evo_tpu/kernels/harris.py`.

On the card, `detect_corners` is two kernel launches and no host read: the
response comes from `kernels.frame_maps` (with the frame's other maps) and
the selection from `kernels.corner_select`. Its plain version
`detect_corners_ref` is the response's convolutions (`harris_response`) and
`corner_select.corner_select_ref`, whose min-distance selection runs as
OpenCV's serial greedy pass on the host over the top-K candidates: the JAX
package's [K, K] fixpoint exists to avoid a serial loop on the TPU and
reaches the same set.
"""

from __future__ import annotations

import torch

from evo_tpu_torch.kernels.gradients import SOBEL_X, SOBEL_Y, conv2same


def harris_response(img, block_size: int = 3, k: float = 0.04,
                    sobel_scale: float = 0.25):
    """Harris response R = det(M) - k·tr(M)² with a box-summed structure
    tensor over `block_size`, like OpenCV's cornerHarris."""
    gx = conv2same(img, SOBEL_X) * sobel_scale
    gy = conv2same(img, SOBEL_Y) * sobel_scale
    box = torch.ones((block_size, block_size), dtype=img.dtype, device=img.device)
    ixx = conv2same(gx * gx, box)
    iyy = conv2same(gy * gy, box)
    ixy = conv2same(gx * gy, box)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def detect_corners_ref(img, *, max_corners: int = 100, quality_level: float = 0.01,
                       min_distance: float = 10.0, block_size: int = 3, k: float = 0.04,
                       border: int = 13):
    """Plain version of `detect_corners`."""
    from evo_tpu_torch.kernels import corner_select

    return corner_select.corner_select_ref(
        harris_response(img, block_size, k), max_corners=max_corners,
        quality_level=quality_level, min_distance=min_distance, border=border)


def detect_corners(img, *, max_corners: int = 100, quality_level: float = 0.01,
                   min_distance: float = 10.0, block_size: int = 3, k: float = 0.04,
                   border: int = 13):
    """goodFeaturesToTrack-equivalent corner selection on img [H, W].

    Returns tensors on the image's device (xy [max_corners, 2] f32, score
    [max_corners] f32, valid [max_corners] bool), strongest first. An image
    on the card takes the kernels (`frame_maps`, then `corner_select`; they
    compute the reference's 3x3 block and k = 0.04), one on the CPU the
    plain version."""
    if img.device.type == "cpu":
        return detect_corners_ref(img, max_corners=max_corners, quality_level=quality_level,
                                  min_distance=min_distance, block_size=block_size, k=k,
                                  border=border)
    from evo_tpu_torch.kernels import corner_select, frame_maps

    if block_size != 3 or k != 0.04:
        raise ValueError("the frame_maps kernel computes the 3x3 block and k = 0.04 only")
    return corner_select.corner_select(
        frame_maps.frame_maps(img)[1], max_corners=max_corners, quality_level=quality_level,
        min_distance=min_distance, border=border)
