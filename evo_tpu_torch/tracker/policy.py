"""Per-frame policy on the table's device — slot allocation, association,
insertion.

Counterpart of `evo_tpu/tracker/policy.py`. The rules are those of the host
policy (`detector.EventTracker._frame_policy`), row and rank order included,
so both give the same decisions on the same table:

- gradient-slot allocation: the first slot no live patch references, else
  the slot of the oldest detection frame, whose patches are evicted;
- greedy association: each live patch, in row order, claims its nearest
  unclaimed corner within `association_distance`;
- insertion: the k-th unclaimed corner goes into the k-th free row, bounded
  by the live cap.

On the card the policy is one kernel launch (`kernels.frame_policy`); on the
CPU it is the plain version `frame_policy_ref`. Neither reads anything back
to the host, so the frame's decisions never wait for a transfer; the host
learns of them from the frame log it consumes later.
"""

from __future__ import annotations

import dataclasses

import torch

from evo_tpu_torch.core.device import resolve
from evo_tpu_torch.dist.mesh import gather_rows
from evo_tpu_torch.kernels import frame_policy as policy_kernel
from evo_tpu_torch.tracker import patch_state as ps


@dataclasses.dataclass
class PolicyState:
    """Policy state on the device (the host's copies lag behind it)."""

    slot_birth: torch.Tensor  # [SLOTS] int32 detection-frame number, -1 = never
    next_tid: torch.Tensor  # [] int32 next track id to allocate
    frame_no: torch.Tensor  # [] int32 detection-frame counter


def empty_state(n_slots: int = ps.MAX_PATCHES, device=None) -> PolicyState:
    """A fresh state on `device` (None: the card when there is one)."""
    device = resolve(device)
    return PolicyState(
        slot_birth=torch.full((n_slots,), -1, dtype=torch.int32, device=device),
        next_tid=torch.zeros((), dtype=torch.int32, device=device),
        frame_no=torch.zeros((), dtype=torch.int32, device=device),
    )


@dataclasses.dataclass
class TableView:
    """The four control fields of the patch table the policy reads."""

    alive: torch.Tensor  # [P] bool
    center: torch.Tensor  # [P, 2] f32
    track_id: torch.Tensor  # [P] int32
    grad_slot: torch.Tensor  # [P] int32

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]


def gathered_view(table, group) -> TableView:
    """The global [P] view from this rank's block of the table rows (a
    `ps.PatchTable` or a `TableView`): one `all_gather` over `group`, whose
    ranks are in block order (`dist.mesh.table_group`), so every rank holds
    the same view and derives the same decisions from it. The JAX package
    scatters each block into zeros and `psum`s them; the four fields travel
    as int32 columns, bool as 0/1 (`dist.mesh.gather_rows`). `group` None:
    the table's own fields, which are then all its rows."""
    return TableView(**gather_rows(
        {k: getattr(table, k) for k in ("alive", "center", "track_id", "grad_slot")}, group))


def slot_refcounts(table, n_slots: int):
    """[SLOTS] int32 live references per gradient slot: a slot is referenced
    by every live patch born on it."""
    ref = (table.alive & (table.track_id >= 0)).to(torch.int32)
    return torch.zeros(n_slots, dtype=torch.int32, device=ref.device).index_add_(
        0, table.grad_slot.long(), ref)


def frame_policy(table, state: PolicyState, corners_xy, corners_ok, *,
                 max_patches: int, association_distance: float):
    """The per-frame policy (`frame_policy_ref`'s arguments and results): a
    table on the card takes the kernel (`kernels.frame_policy`, one launch),
    a table on the CPU the plain version."""
    kw = dict(max_patches=max_patches, association_distance=association_distance)
    if table.alive.device.type == "cpu":
        return frame_policy_ref(table, state, corners_xy, corners_ok, **kw)
    dec, (slot_birth, next_tid, frame_no) = policy_kernel.frame_policy(
        table, state.slot_birth, state.next_tid, state.frame_no, corners_xy, corners_ok, **kw)
    return dec, PolicyState(slot_birth=slot_birth, next_tid=next_tid, frame_no=frame_no)


def frame_policy_ref(table, state: PolicyState, corners_xy, corners_ok, *,
                     max_patches: int, association_distance: float):
    """Plain version of `frame_policy`. `table` is a `ps.PatchTable` or a
    `TableView`; corners_xy [C, 2] f32 and corners_ok [C] bool lie on its
    device.

    Returns (decisions, new state). Decisions, all tensors:
      slot       [] int32    gradient slot for this frame
      evict      [P] bool    patches killed by slot eviction
      new_mask   [P] bool    rows receiving a new detection
      new_center [P, 2] f32
      new_tid    [P] int32   (-1 where not new)
      n_new      [] int32
    """
    dev = table.alive.device
    c = corners_xy.shape[0]
    i32 = torch.int32
    # constants made on the device (`full`, not a copy from the host, which
    # would wait for the device)
    big = torch.full((), 3.4e38, dtype=torch.float32, device=dev)

    # gradient slot: argmax / argmin return the first of equal values, as
    # numpy's do on the host
    free = slot_refcounts(table, state.slot_birth.shape[0]) == 0
    has_free = free.any()
    slot = torch.where(has_free, free.to(i32).argmax(),
                       state.slot_birth.argmin()).to(i32)
    evict = ~has_free & table.alive & (table.grad_slot == slot)
    alive = table.alive & ~evict
    n_live = alive.sum().to(i32)

    # greedy association. Row i's claim depends on the claims of the rows
    # before it, so the rows are walked in order; every step is device work
    claimed = torch.zeros(c, dtype=torch.bool, device=dev)
    if c:
        d2 = ((corners_xy[None, :, :] - table.center[:, None, :]) ** 2).sum(-1)  # [P, C]
        d2 = torch.where(corners_ok[None, :], d2, big)
        thresh2 = torch.full((), association_distance * association_distance,
                             dtype=torch.float32, device=dev)
        col = torch.arange(c, device=dev)
        for i in range(table.capacity):
            di = torch.where(claimed, big, d2[i])
            dmin, j = di.min(dim=0)
            claimed = claimed | ((col == j) & alive[i] & (dmin < thresh2))

    # insertion: k-th unclaimed corner -> k-th free row
    sel_c = corners_ok & ~claimed
    c_rank = torch.cumsum(sel_c, 0, dtype=i32)  # 1-based where sel_c
    free_r = ~alive
    r_rank = torch.cumsum(free_r, 0, dtype=i32)
    budget = (max_patches - n_live).clamp_min(0)
    k_max = torch.minimum(budget, sel_c.sum().to(i32))
    match = (free_r[:, None] & sel_c[None, :]
             & (r_rank[:, None] == c_rank[None, :])
             & (r_rank[:, None] <= k_max))  # at most one true per row and column
    new_mask = match.any(dim=1)
    new_center = match.to(torch.float32) @ corners_xy
    new_tid = torch.where(new_mask, state.next_tid + r_rank - 1,
                          torch.full((), -1, dtype=i32, device=dev)).to(i32)
    n_new = new_mask.sum().to(i32)

    slot_birth = state.slot_birth.clone()
    slot_birth.index_copy_(0, slot.long()[None], state.frame_no[None])
    new_state = PolicyState(slot_birth=slot_birth, next_tid=state.next_tid + n_new,
                            frame_no=state.frame_no + 1)
    decisions = dict(slot=slot, evict=evict, new_mask=new_mask,
                     new_center=new_center, new_tid=new_tid, n_new=n_new)
    return decisions, new_state
