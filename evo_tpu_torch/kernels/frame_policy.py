"""The tracker's per-frame policy as one CUDA kernel of one block: slot
allocation and eviction, greedy association (each live row's candidate
list built by a thread, the claims resolved in conflict waves), insertion,
and the new state.

Counterpart of `evo_tpu/tracker/policy.py::frame_policy` (XLA device code:
the JAX package has no Pallas kernel here). The kernel is
`csrc/frame_policy.cu`, built at first use by `kernels.nvcc` with
`-fmad=false`; it takes tensors on the card only (a CPU tensor, a failed
build or a failed launch raises) and reads nothing back. Its plain version
is `tracker.policy.frame_policy_ref`, and `tracker.policy.frame_policy`
picks between the two by the view's device.
"""

from __future__ import annotations

import array
import ctypes
import functools
import threading

import numpy as np
import torch

from evo_tpu_torch.kernels import nvcc

# the most rows and slots a launch takes (csrc/frame_policy.cu's kMaxRows):
# one block holds every row's list of 8 candidates and centre, the corners
# (at most `corner_select.MAX_CORNERS`) and the slots' counts in its shared
# memory, 229,376 bytes at the most of each
MAX_ROWS = 2048
MAX_CORNERS = 2048  # csrc/frame_policy.cu's kMaxCorners

# Launches of the kernel since the last reset
launches_frame_policy = 0
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches_frame_policy
    with _count_lock:
        launches_frame_policy = 0


def _count() -> None:
    global launches_frame_policy
    with _count_lock:
        launches_frame_policy += 1


VIEW = (("alive", torch.bool), ("center", torch.float32), ("track_id", torch.int32),
        ("grad_slot", torch.int32))
DECISIONS = ("slot", "evict", "new_mask", "new_center", "new_tid", "n_new")
STATE = ("slot_birth", "next_tid", "frame_no")
# the entry's pointer array, in csrc/frame_policy.cu's `Args` order
POINTERS = (tuple(n for n, _ in VIEW) + ("corners_xy", "corners_ok") + STATE + DECISIONS
            + tuple(f"{n}_out" for n in STATE) + ("clocks",))
# the clock build's stages, in csrc/frame_policy.cu's `Stage` order
STAGES = ("load", "slots", "lists", "waves", "insert", "total")
# the clock build's output: each stage's cycles, then the waves the
# association ran (those that had a pending row)
CLOCK_SLOTS = STAGES + ("wave_count",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # the address of the pointer array, P, C, S, max_patches, thresh2, stream
    "evo_frame_policy": ([_P, _I, _I, _I, _I, _F, _P], _I),
}
_libs: dict[bool, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def _lib(clocks: bool = False):
    """The compiled kernel (built from csrc/frame_policy.cu at first use);
    with `clocks`, its clock build (-DEVO_FP_CLOCKS), a library of its own."""
    lib = _libs.get(clocks)  # built: no lock on the launch's path
    if lib is not None:
        return lib
    with _lib_lock:
        if clocks not in _libs:
            name, flags = "evo_frame_policy", ("-fmad=false",)
            if clocks:
                name, flags = name + "_clock", flags + ("-DEVO_FP_CLOCKS",)
            _libs[clocks] = nvcc.load(name, ["frame_policy.cu"], _SIGNATURES, extra_flags=flags,
                                      headers=("block_scan.cuh",))
        return _libs[clocks]


def _outputs(p: int, s: int, dev) -> dict:
    """The decisions and the new state in one int32 allocation: slot, n_new,
    next_tid, frame_no, new_tid [P], slot_birth [S], new_center [P, 2] (as
    float32), then evict and new_mask [P] (as bytes)."""
    arena = torch.empty(4 + p + s + 2 * p + (2 * p + 3) // 4, dtype=torch.int32, device=dev)
    at = 4 + p + s
    flags = arena[at + 2 * p:].view(torch.uint8)
    return dict(slot=arena[0], n_new=arena[1], next_tid_out=arena[2], frame_no_out=arena[3],
                new_tid=arena[4:4 + p], slot_birth_out=arena[4 + p:at],
                new_center=arena[at:at + 2 * p].view(torch.float32).view(p, 2),
                evict=flags[:p].view(torch.bool), new_mask=flags[p:2 * p].view(torch.bool))


@functools.lru_cache(maxsize=16)
def _thresh2(association_distance: float) -> float:
    """association_distance^2 in float32, as the plain version's threshold
    (an overflow raises); cached by distance, since `np.errstate` costs
    more host time than the rest of a launch's arguments."""
    with np.errstate(over="raise"):
        return float(np.float32(association_distance * association_distance))


def run(fn, launch, view, slot_birth, next_tid, frame_no, corners_xy, corners_ok, *,
        max_patches: int, association_distance: float, clocks=None):
    """`frame_policy` through the C entry `fn` and `launch(fn, *args)` (the
    entry's arguments without the stream), after the checks: the tensors on
    one device, of the kernel's types and shapes; `clocks`, an int64
    [len(CLOCK_SLOTS)] tensor, takes the clock build's cycles and wave count
    (None: no clocks).
    Returns (decisions, (slot_birth, next_tid, frame_no))."""
    dev = view.center.device
    p, c, s = view.alive.shape[0], corners_xy.shape[0], slot_birth.shape[0]
    if not (p <= MAX_ROWS and 1 <= s <= MAX_ROWS and c <= MAX_CORNERS):
        raise ValueError(f"the policy kernel takes at most {MAX_ROWS} rows, 1 to {MAX_ROWS} "
                         f"slots and at most {MAX_CORNERS} corners, not {p}, {s} and {c}")
    ptrs = {name: nvcc.pointer(getattr(view, name), f"view.{name}", dtype,
                         (p, 2) if name == "center" else (p,), dev) for name, dtype in VIEW}
    ptrs.update(corners_xy=nvcc.pointer(corners_xy, "corners_xy", torch.float32, (c, 2), dev),
                corners_ok=nvcc.pointer(corners_ok, "corners_ok", torch.bool, (c,), dev),
                slot_birth=nvcc.pointer(slot_birth, "slot_birth", torch.int32, (s,), dev),
                next_tid=nvcc.pointer(next_tid, "next_tid", torch.int32, (), dev),
                frame_no=nvcc.pointer(frame_no, "frame_no", torch.int32, (), dev))
    out = _outputs(p, s, dev)
    ptrs.update({k: v.data_ptr() for k, v in out.items()})
    ptrs["clocks"] = 0 if clocks is None else nvcc.pointer(
        clocks, "clocks", torch.int64, (len(CLOCK_SLOTS),), dev)
    packed = array.array("Q", [ptrs[k] for k in POINTERS])
    launch(fn, packed.buffer_info()[0], p, c, s, int(max_patches),
           _thresh2(association_distance))
    return ({k: out[k] for k in DECISIONS},
            tuple(out[f"{k}_out"] for k in STATE))


def frame_policy(view, slot_birth, next_tid, frame_no, corners_xy, corners_ok, *,
                 max_patches: int, association_distance: float, clocks=None):
    """One launch: the policy's decisions on the table's view (alive [P]
    bool, center [P, 2] float32, track_id and grad_slot [P] int32) and the
    state (slot_birth [S], next_tid [], frame_no [] int32) for the corners
    corners_xy [C, 2] float32 with corners_ok [C] bool, all on the card
    (`tracker.policy.frame_policy_ref`'s rules, to the bit). Returns
    (decisions, (slot_birth, next_tid, frame_no)) as new tensors. `clocks`,
    an int64 [len(CLOCK_SLOTS)] tensor on the card, launches the clock build
    instead, which writes its cycles by stage and its wave count there (the
    main path never passes it)."""
    dev = view.center.device
    if dev.type != "cuda":
        raise RuntimeError(
            f"frame_policy has no kernel for device {dev}: the plain version is "
            "tracker.policy.frame_policy_ref (tracker.policy.frame_policy picks it for a view "
            "on the CPU)")
    out = run(_lib(clocks is not None).evo_frame_policy,
              lambda fn, *args: nvcc.launch(fn, view.center, *args),
              view, slot_birth, next_tid, frame_no, corners_xy, corners_ok,
              max_patches=max_patches, association_distance=association_distance,
              clocks=clocks)
    _count()
    return out
