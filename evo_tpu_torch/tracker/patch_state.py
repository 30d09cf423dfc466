"""Patch table: fixed-capacity struct-of-arrays feature-track state.

Counterpart of `evo_tpu/tracker/patch_state.py`, with the same fields,
dtypes and constants. The table is a dataclass of tensors on one device;
operations return a new table (fields that an operation leaves alone are
shared, not copied).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from evo_tpu_torch.core.device import resolve
from evo_tpu_torch.kernels import route_events as route_kernel

PATCH_EXTENT = 12
PATCH_SIDE = 2 * PATCH_EXTENT + 1  # 25
MAX_PATCHES = 128
MAX_EVENTS = 320
INIT_NUM_EVENTS = 75
MIN_NUM_EVENTS = 100
MAX_NUM_EVENTS = 300
READY_COUNTER = 30


@dataclasses.dataclass
class PatchTable:
    """Leading dimension P (the capacity) everywhere."""

    alive: torch.Tensor  # [P] bool
    initialized: torch.Tensor  # [P] bool
    track_id: torch.Tensor  # [P] int32, -1 for free rows
    center: torch.Tensor  # [P, 2] f32 current rect center (x, y)
    init_pt: torch.Tensor  # [P, 2] f32 center at detection
    warp: torch.Tensor  # [P, 4] f32 SE2 current -> keyframe
    flow: torch.Tensor  # [P] f32 flow angle (rad)
    num_of_events: torch.Tensor  # [P] int32 adaptive event budget
    counter: torch.Tensor  # [P] int32 events since the last solve
    ev_t: torch.Tensor  # [P, E] f32 ring: seconds since the epoch
    ev_x: torch.Tensor  # [P, E] f32
    ev_y: torch.Tensor  # [P, E] f32
    ev_p: torch.Tensor  # [P, E] f32
    ev_count: torch.Tensor  # [P] int32 events ever routed
    grad_slot: torch.Tensor  # [P] int32 gradient-store slot
    final_costs: torch.Tensor  # [P, 5] f32 rolling final-cost history
    n_costs: torch.Tensor  # [P] int32
    cur_t: torch.Tensor  # [P] f32 mid time of the last integration set
    last_update_t: torch.Tensor  # [P] f32
    time_without_update: torch.Tensor  # [P] f32 seconds

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    def replace(self, **changes) -> "PatchTable":
        return dataclasses.replace(self, **changes)


FIELDS = [f.name for f in dataclasses.fields(PatchTable)]


def empty_table(p: int = MAX_PATCHES, e: int = MAX_EVENTS,
                device=None) -> PatchTable:
    """An empty table on `device` (None: the card when there is one)."""
    device = resolve(device)
    f32, i32 = torch.float32, torch.int32

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return PatchTable(
        alive=z(p, torch.bool),
        initialized=z(p, torch.bool),
        track_id=torch.full((p,), -1, dtype=i32, device=device),
        center=z((p, 2), f32),
        init_pt=z((p, 2), f32),
        warp=torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).repeat(p, 1),
        flow=z(p, f32),
        num_of_events=torch.full((p,), INIT_NUM_EVENTS, dtype=i32, device=device),
        counter=z(p, i32),
        ev_t=z((p, e), f32),
        ev_x=z((p, e), f32),
        ev_y=z((p, e), f32),
        ev_p=z((p, e), f32),
        ev_count=z(p, i32),
        grad_slot=z(p, i32),
        final_costs=z((p, 5), f32),
        n_costs=z(p, i32),
        cur_t=z(p, f32),
        last_update_t=z(p, f32),
        time_without_update=torch.full((p,), 10.0, dtype=f32, device=device),
    )


def table_from_numpy(d: dict, device=None) -> PatchTable:
    """A table on `device` (None: the card when there is one) from numpy
    arrays keyed by field name (e.g. `np.asarray` of each field of the JAX
    package's PatchTable)."""
    device = resolve(device)
    return PatchTable(**{k: torch.tensor(np.asarray(d[k]), device=device)
                         for k in FIELDS})


def table_to_numpy(t: PatchTable) -> dict:
    return {k: getattr(t, k).cpu().numpy() for k in FIELDS}


def is_ready(table: PatchTable):
    """>= READY_COUNTER new events and a full buffer."""
    size = torch.clamp(table.ev_count, max=table.ev_t.shape[1])
    return (table.counter >= READY_COUNTER) & (size >= table.num_of_events)


def route_events(table: PatchTable, ex, ey, et, ep, ev_mask) -> PatchTable:
    """Append each event to every live patch whose current rect contains it
    (`route_events_ref`'s arguments and rules): a table on the card takes
    the kernel (`kernels.route_events`, one launch, nothing read back), a
    table on the CPU the plain version."""
    if table.center.device.type == "cpu":
        return route_events_ref(table, ex, ey, et, ep, ev_mask)
    return route_kernel.route_events(table, ex, ey, et, ep, ev_mask)


def route_events_ref(table: PatchTable, ex, ey, et, ep, ev_mask) -> PatchTable:
    """Plain version of `route_events`: append each event to every live
    patch whose current rect contains it.

    ex, ey, et, ep: [N] f32; ev_mask: [N] bool. Events must be in time order.
    The ring keeps the newest E events per patch. Only the newest <= E hits
    of each patch are written; they land in distinct ring slots, so every
    slot receives at most one write and the result does not depend on the
    order in which the device performs the writes.
    """
    p, e = table.ev_t.shape
    inx = (ex[None, :] - table.center[:, 0:1]).abs() <= PATCH_EXTENT
    iny = (ey[None, :] - table.center[:, 1:2]).abs() <= PATCH_EXTENT
    hit = inx & iny & table.alive[:, None] & ev_mask[None, :]  # [P, N]
    rank1 = torch.cumsum(hit, dim=1, dtype=torch.int32)  # 1-based rank
    tot = rank1[:, -1:]
    keep = hit & (rank1 > tot - e)
    row, col = torch.nonzero(keep, as_tuple=True)
    slot = (table.ev_count[row] + rank1[row, col] - 1).remainder(e).long()
    ring = []
    for buf, val in ((table.ev_t, et), (table.ev_x, ex), (table.ev_y, ey),
                     (table.ev_p, ep)):
        buf = buf.clone()
        buf[row, slot] = val[col]
        ring.append(buf)
    n_hit = tot[:, 0]
    return table.replace(
        ev_t=ring[0], ev_x=ring[1], ev_y=ring[2], ev_p=ring[3],
        ev_count=table.ev_count + n_hit,
        counter=table.counter + n_hit,
    )


def newest_events(table: PatchTable):
    """Per patch (t, x, y, p, valid) [P, E] in ring layout; valid marks the
    newest min(count, num_of_events) entries — the integration set."""
    p, e = table.ev_t.shape
    idx = torch.arange(e, device=table.ev_t.device)[None, :]
    count = table.ev_count[:, None]
    size = torch.clamp(count, max=e)
    last = (count - 1).remainder(e)
    age = (last - idx).remainder(e)
    take = torch.minimum(size, table.num_of_events[:, None])
    valid = (age < size) & (age < take)
    return table.ev_t, table.ev_x, table.ev_y, table.ev_p, valid


MIRROR_FIELDS = ("alive", "initialized", "track_id", "center", "ev_count",
                 "num_of_events", "grad_slot", "cur_t")
