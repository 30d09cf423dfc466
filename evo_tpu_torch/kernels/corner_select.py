"""The frame's corner selection from its Harris response as one CUDA kernel.

Counterpart of the selection in `evo_tpu/kernels/harris.py::detect_corners`
(border mask, quality threshold, 3x3 non-maximum suppression, the top 4 x
max_corners candidates, the greedy min-distance pass and the compaction in
rank order; XLA device code: the JAX package has no Pallas kernel here).
The kernel is `csrc/corner_select.cu`, one thread-block cluster (the
candidate pass spread over its blocks, the sort and the greedy pass in its
first), built at first use by `kernels.nvcc`; its plain PyTorch version is
`corner_select_ref` (a stable sort on the response's device, then
OpenCV's serial greedy pass on the host, the JAX package's [K, K]
fixpoint's set). `corner_select` takes the
kernel for a response on the card (a failed build or launch raises) and
the plain version for one on the CPU. Both return tensors on the
response's device: xy [max_corners, 2] float32, score [max_corners]
float32, valid [max_corners] bool, strongest first.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch
import torch.nn.functional as F

from evo_tpu_torch.kernels import nvcc

# Launches of the kernel since the last reset
launches_corner_select = 0
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches_corner_select
    with _count_lock:
        launches_corner_select = 0


def _count() -> None:
    global launches_corner_select
    with _count_lock:
        launches_corner_select += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # resp, H, W, border, quality, min_d2, max_corners, K, Kpad, xy, score, valid, clocks,
    # stream
    "evo_corner_select": ([_P, _I, _I, _I, _F, _F, _I, _I, _I, _P, _P, _P, _P, _P], _I),
    "evo_corner_select_smem": ([_I, _I, _I, _I], ctypes.c_longlong),
}
# the most corners a launch selects: its accepted list and K = 4 max_corners
# keys lie in the first block's shared memory (12 bytes a key, 12 a corner;
# 120 KB at 2,048, with room for a block's slice of a 1080x1440 bitmask)
MAX_CORNERS = 2048
SMEM_MAX = 232448  # the dynamic shared memory a block of the card can take
# the clock build's stages, in csrc/corner_select.cu's `Stage` order
STAGES = ("max", "candidates", "select", "sort", "greedy", "write", "total")
_libs: dict[bool, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def _lib(clocks: bool = False):
    """The compiled kernel (built from csrc/corner_select.cu at first use);
    with `clocks`, its clock build (-DEVO_CS_CLOCKS), a library of its own."""
    with _lib_lock:
        if clocks not in _libs:
            name, flags = "evo_corner_select", ("-fmad=false",)
            if clocks:
                name, flags = name + "_clock", flags + ("-DEVO_CS_CLOCKS",)
            _libs[clocks] = nvcc.load(name, ["corner_select.cu"], _SIGNATURES, extra_flags=flags)
        return _libs[clocks]


def select_kwargs(params) -> dict:
    """The selection's arguments from a `TrackerParams` (border: the patch
    extent + 1, as the tracker calls it)."""
    from evo_tpu_torch.tracker import patch_state as ps

    return dict(max_corners=params.max_patches, quality_level=params.quality_level,
                min_distance=params.min_distance, border=ps.PATCH_EXTENT + 1)


def maxpool_same(x, size: int):
    """size x size max filter with stride 1 and -inf padding ('SAME')."""
    return F.max_pool2d(x[None, None], size, stride=1, padding=size // 2)[0, 0]


def masked_scores(resp, *, max_corners: int = 100, quality_level: float = 0.01,
                  min_distance: float = 10.0, border: int = 13, nms_size: int = 3):
    """The candidates' scores [H W] (flat): the response where it is a peak
    of its window, inside the border, above quality x the largest response
    inside the border and above 0; -inf elsewhere."""
    h, w = resp.shape
    is_peak = resp >= maxpool_same(resp, nms_size)
    ys = torch.arange(h, device=resp.device)[:, None]
    xs = torch.arange(w, device=resp.device)[None, :]
    in_border = (xs >= border) & (xs < w - border) & (ys >= border) & (ys < h - border)
    neg_inf = torch.tensor(float("-inf"), dtype=resp.dtype, device=resp.device)
    qmax = torch.where(in_border, resp, neg_inf).max()
    good = is_peak & in_border & (resp > quality_level * qmax) & (resp > 0)
    return torch.where(good, resp, neg_inf).reshape(-1)


def greedy(pos: np.ndarray, ok: np.ndarray, min_d2: float) -> np.ndarray:
    """Accept candidates in rank order unless an accepted one lies closer
    than min_distance (squared distance < min_d2)."""
    accepted = np.zeros(len(pos), bool)
    acc = []
    for i in np.flatnonzero(ok):
        if acc:
            d2 = ((pos[acc] - pos[i]) ** 2).sum(-1)
            if (d2 < min_d2).any():
                continue
        accepted[i] = True
        acc.append(i)
    return accepted


def _top_k(resp, max_corners: int, **kw):
    """(scores, flat indices) of the top K = 4 max_corners candidates, ties
    to the lower flat index (`lax.top_k`'s rule), as host numpy."""
    h, w = resp.shape
    scores = masked_scores(resp, max_corners=max_corners, **kw)
    kk = min(4 * max_corners, h * w)
    top_scores, top_idx = torch.sort(scores, descending=True, stable=True)
    return top_scores[:kk].cpu().numpy(), top_idx[:kk].cpu().numpy()


def corner_select_ref(resp, *, max_corners: int = 100, quality_level: float = 0.01,
                      min_distance: float = 10.0, border: int = 13):
    """Plain version of `corner_select`: (xy, score, valid) on the
    response's device."""
    w = resp.shape[1]
    top_scores, top_idx = _top_k(resp, max_corners, quality_level=quality_level,
                                 min_distance=min_distance, border=border)
    pos = np.stack([top_idx % w, top_idx // w], axis=-1).astype(np.float32)
    accepted = greedy(pos, np.isfinite(top_scores), np.float32(min_distance * min_distance))
    sel = np.flatnonzero(accepted)[:max_corners]
    xy = np.zeros((max_corners, 2), np.float32)
    valid = np.zeros(max_corners, bool)
    score = np.zeros(max_corners, np.float32)
    xy[: len(sel)] = pos[sel]
    valid[: len(sel)] = True
    score[: len(sel)] = top_scores[sel]
    dev = resp.device
    return (torch.from_numpy(xy).to(dev), torch.from_numpy(score).to(dev),
            torch.from_numpy(valid).to(dev))


def key_counts(h: int, w: int, max_corners: int) -> tuple[int, int]:
    """(K, Kpad): the candidates a selection ranks, min(4 max_corners, H W),
    and the sort's length, the power of two at or above K and 32 (whole
    warps)."""
    k = min(4 * max_corners, h * w)
    return k, max(32, 1 << max(k - 1, 1).bit_length())


def run(fn, resp, launch, *, max_corners: int, quality_level: float, min_distance: float,
        border: int, clocks=None):
    """Allocate the outputs and `launch(fn, resp, H, W, border, quality,
    min_d2, max_corners, K, Kpad, xy, score, valid, clocks)` (the C entry's
    arguments without the stream; `clocks` an int64 [len(STAGES)] tensor for
    the clock build, or None). Returns (xy, score, valid)."""
    h, w = resp.shape
    k, kpad = key_counts(h, w, max_corners)
    out = torch.empty(3 * max_corners + (max_corners + 3) // 4, dtype=torch.float32,
                      device=resp.device)
    xy = out[:2 * max_corners].view(max_corners, 2)
    score = out[2 * max_corners:3 * max_corners]
    valid = out[3 * max_corners:].view(torch.uint8)[:max_corners].view(torch.bool)
    launch(fn, resp.data_ptr(), h, w, border, float(np.float32(quality_level)),
           float(np.float32(min_distance * min_distance)), max_corners, k, kpad,
           xy.data_ptr(), score.data_ptr(), valid.data_ptr(),
           0 if clocks is None else clocks.data_ptr())
    return xy, score, valid


def corner_select(resp, *, max_corners: int = 100, quality_level: float = 0.01,
                  min_distance: float = 10.0, border: int = 13, clocks=None):
    """Corners of the Harris response resp [H, W]: (xy [max_corners, 2],
    score [max_corners], valid [max_corners] bool) on its device, strongest
    first. One kernel launch for a response on the card (nothing is read
    back), the plain version on the CPU. `clocks`, an int64 [len(STAGES)]
    tensor on the card, launches the clock build instead, which writes its
    cycles by stage there (the main path never passes it)."""
    kw = dict(max_corners=max_corners, quality_level=quality_level,
              min_distance=min_distance, border=border)
    if resp.device.type == "cpu":
        return corner_select_ref(resp, **kw)
    if resp.device.type != "cuda":
        raise RuntimeError(f"corner_select has no kernel for device {resp.device}")
    if resp.dim() != 2 or resp.dtype != torch.float32 or not resp.is_contiguous():
        raise ValueError(f"corner_select takes a contiguous float32 [H, W] response, got "
                         f"{resp.dtype} {tuple(resp.shape)}")
    if not 1 <= max_corners <= MAX_CORNERS:
        raise ValueError(f"the kernel selects 1 to {MAX_CORNERS} corners, not {max_corners}")
    lib = _lib(clocks is not None)
    h, w = resp.shape
    smem = lib.evo_corner_select_smem(h, w, key_counts(h, w, max_corners)[1], max_corners)
    if smem > SMEM_MAX:
        raise ValueError(f"a {h}x{w} response with {max_corners} corners needs {smem} bytes "
                         f"of shared memory a block, more than the card's {SMEM_MAX}")
    outs = run(lib.evo_corner_select, resp, lambda fn, *args: nvcc.launch(fn, resp, *args),
               **kw, clocks=clocks)
    _count()
    return outs


def same_corners(got, ref) -> dict:
    """Two selections compared: the same valid rows, positions and order
    (`equal`), the largest score difference, the number accepted."""
    g = [t.cpu() for t in got]
    r = [t.cpu() for t in ref]
    same = torch.equal(g[2], r[2]) and torch.equal(g[0], r[0])
    err = float((g[1] - r[1]).abs().max()) if len(g[1]) else 0.0
    return dict(equal=bool(same and err == 0.0), max_abs_err=err,
                accepted=int(g[2].sum()), accepted_ref=int(r[2].sum()))


def candidates(resp, **kw) -> int:
    """How many candidates the response holds (the top-K's pool)."""
    return int(torch.isfinite(masked_scores(resp, **kw)).sum())
