"""Event routing into the patch table's rings as one CUDA kernel, a block a
patch.

Counterpart of `evo_tpu/tracker/patch_state.py::route_events` (XLA device
code: the JAX package has no Pallas kernel here). The kernel is
`csrc/route_events.cu`, built at first use by `kernels.nvcc`; it takes
tensors on the card only (a CPU tensor, a failed build or a failed launch
raises) and reads nothing back. Its plain version is
`tracker.patch_state.route_events_ref`, and `tracker.patch_state.
route_events` picks between the two by the table's device.
"""

from __future__ import annotations

import array
import ctypes
import threading

import torch

from evo_tpu_torch.kernels import nvcc

# Launches of the kernel since the last reset
launches_route_events = 0
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches_route_events
    with _count_lock:
        launches_route_events = 0


def _count() -> None:
    global launches_route_events
    with _count_lock:
        launches_route_events += 1


RING = ("ev_t", "ev_x", "ev_y", "ev_p")
EVENTS = ("et", "ex", "ey", "ep")  # each ring's events, in RING's order
# the entry's pointer array, in csrc/route_events.cu's `Args` order
POINTERS = (("center", "alive", "ev_count", "counter") + RING + EVENTS + ("mask",)
            + tuple(f"{n}_out" for n in RING) + ("ev_count_out", "counter_out"))

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # the address of the pointer array, P, E, N, stream
    "evo_route_events": ([_P, _I, _I, _I, _P], _I),
}
_libs: dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def _lib():
    """The compiled kernel (built from csrc/route_events.cu at first use)."""
    with _lib_lock:
        if "lib" not in _libs:
            _libs["lib"] = nvcc.load("evo_route_events", ["route_events.cu"], _SIGNATURES,
                                     headers=("block_scan.cuh",))
        return _libs["lib"]


def run(fn, launch, table, ex, ey, et, ep, ev_mask) -> dict:
    """The new ring fields, `ev_count` and `counter` of `table` after
    routing the events ex, ey, et, ep [N] float32 with ev_mask [N] bool,
    through the C entry `fn` and `launch(fn, *args)` (the entry's arguments
    without the stream), after the checks: the tensors on one device, of
    the kernel's types and shapes. The outputs are new tensors, in two
    allocations."""
    dev = table.center.device
    p, e = table.ev_t.shape
    n = ex.shape[0]
    if e < 1:
        raise ValueError("the rings hold no slot")
    ptrs = dict(center=nvcc.pointer(table.center, "table.center", torch.float32, (p, 2), dev),
                alive=nvcc.pointer(table.alive, "table.alive", torch.bool, (p,), dev),
                ev_count=nvcc.pointer(table.ev_count, "table.ev_count", torch.int32, (p,), dev),
                counter=nvcc.pointer(table.counter, "table.counter", torch.int32, (p,), dev),
                mask=nvcc.pointer(ev_mask, "ev_mask", torch.bool, (n,), dev))
    for name in RING:
        ptrs[name] = nvcc.pointer(getattr(table, name), f"table.{name}", torch.float32, (p, e), dev)
    for name, t in zip(EVENTS, (et, ex, ey, ep)):
        ptrs[name] = nvcc.pointer(t, name, torch.float32, (n,), dev)
    rings = torch.empty((len(RING), p, e), dtype=torch.float32, device=dev)
    counts = torch.empty((2, p), dtype=torch.int32, device=dev)
    out = dict(zip(RING, rings.unbind(0)), ev_count=counts[0], counter=counts[1])
    ptrs.update({f"{k}_out": v.data_ptr() for k, v in out.items()})
    packed = array.array("Q", [ptrs[k] for k in POINTERS])
    launch(fn, packed.buffer_info()[0], p, e, n)
    return out


def route_events(table, ex, ey, et, ep, ev_mask):
    """One launch: `table` (a `tracker.patch_state.PatchTable` on the card)
    with each event appended to the ring of every live patch whose rect
    holds it (`tracker.patch_state.route_events_ref`'s rules, to the bit).
    Returns the new table; the input is not written."""
    dev = table.center.device
    if dev.type != "cuda":
        raise RuntimeError(
            f"route_events has no kernel for device {dev}: the plain version is "
            "tracker.patch_state.route_events_ref (tracker.patch_state.route_events picks it "
            "for a table on the CPU)")
    out = run(_lib().evo_route_events, lambda fn, *args: nvcc.launch(fn, table.center, *args),
              table, ex, ey, et, ep, ev_mask)
    _count()
    return table.replace(**out)
