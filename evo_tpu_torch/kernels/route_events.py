"""Event routing into the patch table's rings as one CUDA kernel: a block a
patch, in thread-block clusters of 8 patches that read the sub-batch once
a cluster.

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


# the longest ring a launch takes (csrc/route_events.cu's kMaxRing: a block
# holds an event index for each slot of its patch's ring in shared memory);
# the tracker's rings hold `patch_state.MAX_EVENTS` = 320
MAX_RING = 8192
RING = ("ev_t", "ev_x", "ev_y", "ev_p")
EVENTS = ("et", "ex", "ey", "ep")  # each ring's events, in RING's order
# the entry's pointer array, in csrc/route_events.cu's `Args` order
POINTERS = (("center", "alive", "ev_count", "counter") + RING + EVENTS + ("mask",)
            + tuple(f"{n}_out" for n in RING) + ("ev_count_out", "counter_out", "clocks"))
# the clock build's stages, in csrc/route_events.cu's `Stage` order
STAGES = ("load", "sync", "scan", "write", "copy", "total")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # the address of the pointer array, P, E, N, stream
    "evo_route_events": ([_P, _I, _I, _I, _P], _I),
}
_libs: dict[bool, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def _lib(clocks: bool = False):
    """The compiled kernel (built from csrc/route_events.cu at first use);
    with `clocks`, its clock build (-DEVO_RE_CLOCKS), a library of its own."""
    lib = _libs.get(clocks)  # built: no lock on the launch's path
    if lib is not None:
        return lib
    with _lib_lock:
        if clocks not in _libs:
            name, flags = "evo_route_events", ()
            if clocks:
                name, flags = name + "_clock", ("-DEVO_RE_CLOCKS",)
            _libs[clocks] = nvcc.load(name, ["route_events.cu"], _SIGNATURES, extra_flags=flags,
                                      headers=("block_scan.cuh",))
        return _libs[clocks]


def run(fn, launch, table, ex, ey, et, ep, ev_mask, clocks=None) -> dict:
    """The new ring fields, `ev_count` and `counter` of `table` after
    routing the events ex, ey, et, ep [N] float32 with ev_mask [N] bool,
    through the C entry `fn` and `launch(fn, *args)` (the entry's arguments
    without the stream), after the checks: the tensors on one device, of
    the kernel's types and shapes; `clocks`, an int64 [P, len(STAGES)]
    tensor, takes the clock build's cycles (None: no clocks). The outputs
    are new tensors, in two allocations (one allocation and its views
    measured more ATen operations a window and more host time)."""
    dev = table.center.device
    p, e = table.ev_t.shape
    n = ex.shape[0]
    if not 1 <= e <= MAX_RING:
        raise ValueError(f"the routing kernel takes rings of 1 to {MAX_RING} slots, not {e}")
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
    ptrs["clocks"] = 0 if clocks is None else nvcc.pointer(
        clocks, "clocks", torch.int64, (p, len(STAGES)), dev)
    packed = array.array("Q", [ptrs[k] for k in POINTERS])
    launch(fn, packed.buffer_info()[0], p, e, n)
    return out


def route_events(table, ex, ey, et, ep, ev_mask, clocks=None):
    """One launch: `table` (a `tracker.patch_state.PatchTable` on the card)
    with each event appended to the ring of every live patch whose rect
    holds it (`tracker.patch_state.route_events_ref`'s rules, to the bit).
    Returns the new table; the input is not written. `clocks`, an int64
    [P, len(STAGES)] tensor on the card, launches the clock build instead,
    which writes each block's cycles by stage there (the main path never
    passes it)."""
    dev = table.center.device
    if dev.type != "cuda":
        raise RuntimeError(
            f"route_events has no kernel for device {dev}: the plain version is "
            "tracker.patch_state.route_events_ref (tracker.patch_state.route_events picks it "
            "for a table on the CPU)")
    out = run(_lib(clocks is not None).evo_route_events,
              lambda fn, *args: nvcc.launch(fn, table.center, *args),
              table, ex, ey, et, ep, ev_mask, clocks)
    _count()
    return table.replace(**out)
