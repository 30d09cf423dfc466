"""Event tracker front end — detection, association, lifecycle, orchestration.

Counterpart of `evo_tpu/tracker/detector.py`:

- per frame (`new_image`): the frame's maps (the log/Sobel gradient pair,
  the Harris response, the pyramid: `kernels.frame_maps`) and its corners
  (`kernels.corner_select`), read back once with the table's mirror; the
  host policy (gradient-slot allocation and eviction, greedy association,
  insertion of new corners); then one table update that inserts the
  detections and, in one `kernels.frame_rows` launch, bootstraps new
  patches by pyramidal LK from the previous frame's pyramid (kept from its
  frame step) and refreshes the event budgets;
- per window of events (`process_events`): the window is cut into
  sub-batches (bounded by count and duration, scaled up for dense windows),
  packed into the 8-byte-per-event wire layout, unpacked on the device, and
  scanned: route, solve the ready patches, re-budget (align.process_window_scan);
- per frame window (`process_frame_window`, the pipelined drive's step): the
  window's events and its frame in one call, whose logs come back as a
  handle (`core.transfer.HostCopy`) that `consume_frames` reads later. With
  `device_policy` the frame's policy runs on the device (`tracker.policy`)
  and the host learns of its decisions from that log; without it the host
  policy runs between the scan and the frame's table update.

Array math runs on the table's device; the host policy and the artifact logs
are host numpy over [P]-sized mirrors.

With `mesh` (a `dist.mesh.make_mesh` mesh; every rank runs the same tracker
on the same input) each rank holds its block of the table's rows, in the
JAX package's block order (lin = space_index · n_batch + batch_index), and
replicas of the gradient store and the policy state. The window scan runs
on the block (`sharded_window_scan`) and the fused frame window on the block
with the policy on the gathered view (`sharded_fused_step`); every log, and
every host reader of the table (the mirrors, `global_table`), gets the
global rows from one `all_gather` over the tracker's own process group
(`dist.mesh.table_group`). So the host state every rank derives from them
(track ids, archive, trajectories) is the same on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from evo_tpu_torch.core import device as _device
from evo_tpu_torch.core.transfer import HostCopy
from evo_tpu_torch.core.types import US_PER_S
from evo_tpu_torch.dist import mesh as dmesh
from evo_tpu_torch.kernels import corner_select, frame_maps, lk
from evo_tpu_torch.kernels import frame_rows as frame_rows_kernel
from evo_tpu_torch.tracker import align, policy
from evo_tpu_torch.tracker import patch_state as ps


@dataclasses.dataclass
class TrackerParams:
    """Same fields and defaults as the JAX package's TrackerParams."""

    quality_level: float = 0.01
    min_distance: float = 10.0
    association_distance: float = 5.0
    block_size: int = 3
    max_patches: int = 100  # live cap (<= capacity)
    capacity: int = ps.MAX_PATCHES  # table rows == gradient-store slots
    init_num_events: int = 75
    max_num_events_to_store: int = 15_000
    max_lm_iters: int = 10
    optimizer_threshold: float = 0.6
    huber_loss: float = 0.3
    lk_levels: int = 3
    lk_radius: int = 10
    sub_batch_events: int = 5_000
    sub_batch_duration_us: int = 10_000
    # a window carrying more than max_window_steps * sub_batch_events events
    # gets a larger sub-batch cap (bucketed to multiples of 4096); 0 disables
    max_window_steps: int = 6
    # the port always scans a window's sub-batches in order (True)
    use_device_scan: bool = True
    # `process_frame_window` runs the per-frame policy on the device
    # (tracker.policy), so the frame's table update waits for no host
    # decision; False runs the host policy there, after one read of the scan
    # log and the table mirror. No effect on `new_image` / `process_events`,
    # which always use the host policy.
    device_policy: bool = True


# packed event layout for the host -> device upload: x (11 bits) | y << 11
# (11 bits) | polarity-positive << 22, -1 = padding; plus an int32 µs offset
_XY_BITS = 11
_XY_MASK = (1 << _XY_BITS) - 1


def unpack_events(xyp, trel_us, offset_s):
    """[K, C] packed int32 pair + f32 window offset -> (ex, ey, et, ep, mask)."""
    valid = xyp >= 0
    v = torch.where(valid, xyp, torch.zeros_like(xyp))
    ex = (v & _XY_MASK).to(torch.float32)
    ey = ((v >> _XY_BITS) & _XY_MASK).to(torch.float32)
    pos = ((v >> (2 * _XY_BITS)) & 1) == 1
    ep = torch.where(pos, 1.0, -1.0).to(torch.float32)
    et = offset_s + trel_us.to(torch.float32) * torch.tensor(
        1e-6, dtype=torch.float32, device=xyp.device)
    return ex, ey, et, ep, valid


# the frame's gradient pair by the plain version (`_compute_grads`' twin)
compute_grads = frame_maps.gradient_pair


def frame_analyze(img, *, max_corners, quality_level, min_distance,
                  block_size, border):
    """A frame's corners (xy [K, 2], valid [K]) and maps (`frame_maps`:
    gradient pair [2, H, W], Harris response, pyramid levels 1 and 2), all
    on the image's device: two kernel launches on the card, nothing read
    back; the plain versions on the CPU (`compute_grads`,
    `harris.detect_corners_ref`, `gradients.image_pyramid`)."""
    maps = frame_maps.frame_maps(img, block_size)
    xy, _, valid = corner_select.corner_select(
        maps[1], max_corners=max_corners, quality_level=quality_level,
        min_distance=min_distance, border=border)
    return xy, valid, maps


def apply_flow_init(table: ps.PatchTable, flow_xy, status, h: int, w: int):
    """Flow bootstrap of uninitialized patches: φ = atan2(dy, dx), warp
    translation (−dx, −dy); no-flow or border-centred patches are lost."""
    uninit = table.alive & ~table.initialized
    dx, dy = flow_xy[:, 0], flow_xy[:, 1]
    flow_dir = torch.atan2(dy, dx)
    warp = torch.stack([torch.ones_like(dx), torch.zeros_like(dx), -dx, -dy], dim=-1)
    speed = torch.sqrt(dx * dx + dy * dy)
    twu = align.TIME_WITHOUT_UPDATE_SCALE / speed.clamp_min(0.1)
    cx, cy = table.center[:, 0], table.center[:, 1]
    border_lost = (cx <= 5) | (cy <= 5) | (cx >= w - 5) | (cy >= h - 5)
    ok = uninit & status & ~border_lost
    lost = uninit & (~status | border_lost)
    return table.replace(
        alive=table.alive & ~lost,
        initialized=table.initialized | ok,
        warp=torch.where(ok[:, None], warp, table.warp),
        flow=torch.where(ok, flow_dir, table.flow),
        time_without_update=torch.where(ok, twu, table.time_without_update),
    )


def frame_rows_ref(table: ps.PatchTable, prev_pyr, cur_pyr, new_grad, *, with_lk: bool,
                   radius: int = 10, num_iters: int = 30, diagnostics: bool = False):
    """Plain version of `frame_rows`: with `with_lk`, pyramidal LK of the
    rows alive and not initialized (`lk.track_pyramids_ref`) and
    `apply_flow_init`; then `align.update_num_of_events_ref`. With
    `diagnostics`, also LK's flow [P, 2] (0 where not tracked) and status."""
    h, w = new_grad.shape[1], new_grad.shape[2]
    uninit = table.alive & ~table.initialized
    flow_xy = torch.zeros_like(table.center)
    status = torch.zeros_like(uninit)
    if with_lk and (diagnostics or bool(uninit.any())):
        _, flow_xy, status = lk.track_pyramids_ref(prev_pyr, cur_pyr, table.center, uninit,
                                                   radius=radius, num_iters=num_iters)
        flow_xy = torch.where(uninit[:, None], flow_xy, torch.zeros_like(flow_xy))
        table = apply_flow_init(table, flow_xy, status, h, w)
    table = align.update_num_of_events_ref(table, new_grad)
    if diagnostics:
        return table, dict(lk_flow=flow_xy, lk_status=status)
    return table


def frame_rows(table: ps.PatchTable, prev_pyr, cur_pyr, new_grad, *, with_lk: bool,
               radius: int = 10, num_iters: int = 30, diagnostics: bool = False):
    """The frame's row updates after the insertion: LK bootstrap of the new
    patches from pyramid prev_pyr to cur_pyr (level 0 first) with
    `with_lk`, then the border-lost check and every live patch's event
    budget against new_grad [2, H, W]. A table on the card takes one launch
    of `kernels.frame_rows` (no host read decides anything), a table on the
    CPU the plain version `frame_rows_ref`."""
    fn = frame_rows_ref if table.center.device.type == "cpu" else frame_rows_kernel.frame_rows
    return fn(table, prev_pyr, cur_pyr, new_grad, with_lk=with_lk, radius=radius,
              num_iters=num_iters, diagnostics=diagnostics)


def frame_apply(table: ps.PatchTable, grads, new_grad, cur_pyr, prev_pyr, dec: dict,
                *, with_lk: bool, lk_radius: int):
    """The frame's table mutations: evict, write the gradient slot, insert
    the new detections, then `frame_rows` (LK-bootstrap uninitialized
    patches from the previous frame's pyramid prev_pyr to this frame's
    cur_pyr, refresh the event budgets). `dec` is the policy's decision as
    tensors on the table's device: new_mask, evict [P] bool, new_tid [P]
    int32, new_center [P, 2], slot [] integer. Writes the new gradient pair
    into `grads` in place."""
    dev = grads.device
    new_mask, new_tid, new_center = dec["new_mask"], dec["new_tid"], dec["new_center"]
    slot = dec["slot"]
    grads.index_copy_(0, slot.long()[None], new_grad[None])
    m1 = new_mask[:, None]
    table = table.replace(
        alive=(table.alive & ~dec["evict"]) | new_mask,
        initialized=table.initialized & ~new_mask,
        track_id=torch.where(new_mask, new_tid, table.track_id),
        center=torch.where(m1, new_center, table.center),
        init_pt=torch.where(m1, new_center, table.init_pt),
        warp=torch.where(m1, torch.eye(1, 4, device=dev), table.warp),
        flow=torch.where(new_mask, 0.0, table.flow),
        num_of_events=torch.where(
            new_mask, torch.full_like(table.num_of_events, ps.INIT_NUM_EVENTS),
            table.num_of_events),
        counter=torch.where(new_mask, torch.zeros_like(table.counter), table.counter),
        ev_count=torch.where(new_mask, torch.zeros_like(table.ev_count), table.ev_count),
        grad_slot=torch.where(new_mask, slot.to(table.grad_slot.dtype), table.grad_slot),
        final_costs=torch.where(m1, 0.0, table.final_costs),
        n_costs=torch.where(new_mask, torch.zeros_like(table.n_costs), table.n_costs),
        time_without_update=torch.where(new_mask, 10.0, table.time_without_update),
    )
    return frame_rows(table, prev_pyr, cur_pyr, new_grad, with_lk=with_lk, radius=lk_radius)


FRAMELOG_MIRROR = ("alive", "track_id", "center", "grad_slot", "cur_t",
                   "num_of_events")
# the policy's [P] decisions; a rank of a mesh applies its rows of them
ROW_DECISIONS = ("evict", "new_mask", "new_tid", "new_center")


def fused_window_core(table: ps.PatchTable, grads, pstate: policy.PolicyState,
                      events, img, prev_pyr, *, view_fn, slice_fn, with_lk, lk_levels,
                      lk_radius, max_corners, quality_level, min_distance, block_size,
                      border, max_patches, association_distance):
    """One frame window with the policy on the device: the event-window scan
    (`events` = (ex, ey, et, ep, mask) [K, C], or None for a window without
    events), the frame's maps and corners (`frame_analyze`),
    `policy.frame_policy` on those corners, and the table mutation
    (`frame_apply`, LK from the previous frame's pyramid prev_pyr; None
    without LK). Nothing is read back on the card. Writes the frame's
    gradient pair into `grads` in place.
    `view_fn` gives the policy its (global) view of the table and `slice_fn`
    maps the global [P] decisions onto this table's rows (`sharded_fused_step`:
    `policy.gathered_view` and the rank's block, all rows without a mesh).
    Returns (table, pstate, stacked scan log or None, framelog, the frame's
    pyramid), the logs of this table's rows."""
    corners_xy, corners_valid, maps = frame_analyze(
        img, max_corners=max_corners, quality_level=quality_level,
        min_distance=min_distance, block_size=block_size, border=border,
    )
    stacked = None
    if events is not None:
        # the budget update inside the scan samples the newest detection
        # frame's gradients: the slot the previous frame wrote (frame numbers
        # only grow, so argmax finds it; before the first frame, slot 0)
        latest = grads[pstate.slot_birth.argmax()]
        table, stacked = align.process_window_scan(table, grads, *events, latest)
    dec, pstate = policy.frame_policy(
        view_fn(table), pstate, corners_xy, corners_valid,
        max_patches=max_patches, association_distance=association_distance,
    )
    dec = dict(slot=dec["slot"], **{k: slice_fn(dec[k]) for k in ROW_DECISIONS})
    evict_tid = torch.where(dec["evict"], table.track_id,
                            torch.full_like(table.track_id, -1))
    pyr = frame_maps.pyramid(img, maps, lk_levels)
    table = frame_apply(table, grads, maps[0], pyr, prev_pyr, dec,
                        with_lk=with_lk, lk_radius=lk_radius)
    framelog = dict(evict_tid=evict_tid, new_mask=dec["new_mask"],
                    new_tid=dec["new_tid"], new_center=dec["new_center"],
                    **{k: getattr(table, k) for k in FRAMELOG_MIRROR})
    return table, pstate, stacked, framelog, pyr


def _gather_parts(group, parts: dict) -> dict:
    """{part: (dict of row-block tensors, their row axis)} -> {part: dict of
    the global tensors}, all in one collective over `group`."""
    flat = {f"{p}.{k}": v for p, (tree, _) in parts.items() for k, v in tree.items()}
    dims = {f"{p}.{k}": d for p, (tree, d) in parts.items() for k in tree}
    got = dmesh.gather_rows(flat, group, dims)
    return {p: {k: got[f"{p}.{k}"] for k in tree} for p, (tree, _) in parts.items()}


def sharded_window_scan(group, table: ps.PatchTable, grads, ex, ey, et, ep, mask,
                        latest_grad, mirror=()):
    """`align.process_window_scan` on this rank's block of the table rows,
    with the events, the gradient store and the newest gradient slot
    replicated; the stacked log [K, P_local] is gathered to the global
    [K, P] over `group` (the JAX package's `_sharded_window_scan`, out_specs
    P(None, axes)), and with it the global [P] rows of the post-scan table's
    fields named in `mirror`. Patch solves are independent, so each row's
    result is that of the one-device scan. `group` None (no mesh): the
    block is the whole table and nothing is gathered. Returns (this rank's
    block, global log, {field: global rows})."""
    table, stacked = align.process_window_scan(table, grads, ex, ey, et, ep, mask,
                                               latest_grad)
    got = _gather_parts(group, dict(stacked=(stacked, 1),
                                    mirror=({k: getattr(table, k) for k in mirror}, 0)))
    return table, got["stacked"], got["mirror"]


def sharded_fused_step(group, rows: slice, table: ps.PatchTable, grads, pstate,
                       events, img, prev_pyr, **kw):
    """`fused_window_core` on this rank's block `rows` of the table: the
    policy reads the view gathered over `group` (`policy.gathered_view`), so
    every rank computes the same global decisions and applies its own rows
    of them (`frame_rows` runs on the rank's rows: its LK and budgets are a
    row's own); `grads`, `pstate` and the pyramids stay replicas. The scan
    log and the frame log are gathered to the global [K, P] and [P] in one
    `all_gather` (the JAX package's `_sharded_fused_step`). `group` None,
    `rows` all of them: the one-device step. Returns (this rank's block,
    pstate, global scan log or None, global frame log, the frame's
    pyramid)."""
    table, pstate, stacked, framelog, pyr = fused_window_core(
        table, grads, pstate, events, img, prev_pyr,
        view_fn=lambda t: policy.gathered_view(t, group), slice_fn=lambda a: a[rows], **kw)
    got = _gather_parts(group, dict(framelog=(framelog, 0), stacked=(stacked or {}, 1)))
    return (table, pstate, got["stacked"] if stacked is not None else None, got["framelog"],
            pyr)


class FrameHandle(HostCopy):
    """The logs of one `process_frame_window` on their way to the host; `k`
    is the number of sub-batches its scan log holds, `landed` what of the
    logs is on the host already (numpy)."""

    def __init__(self, tree: dict, k: int = 0, landed: dict | None = None):
        super().__init__(tree)
        self.k = k
        self._landed = landed or {}

    def get(self) -> dict:
        return {**super().get(), **self._landed}


class EventTracker:
    """Owns the patch table, the gradient-slot store, track-id allocation
    and the host artifact logs, on one device. With `mesh`, the table's rows
    are split over the mesh's ranks (see the module docstring): `table` is
    this rank's block, `global_table()` and the mirrors the whole."""

    def __init__(self, params: TrackerParams | None = None, height: int = 180,
                 width: int = 240, device=None, mesh=None):
        self.params = params or TrackerParams()
        if not self.params.use_device_scan:
            raise NotImplementedError(
                "the port scans windows only (use_device_scan=True)")
        self.device = _device.resolve(device)
        p = self.params
        if self.device.type == "cuda":  # what the frame kernels take; the CPU takes any
            if p.block_size != 3 or p.lk_levels > frame_rows_kernel.MAX_LEVELS:
                raise ValueError(f"the frame kernels take a 3x3 Harris block and at most "
                                 f"{frame_rows_kernel.MAX_LEVELS} LK levels, not "
                                 f"{p.block_size} and {p.lk_levels} (the CPU takes any)")
            if not 1 <= p.max_patches <= corner_select.MAX_CORNERS:
                raise ValueError(f"the corner kernel selects 1 to {corner_select.MAX_CORNERS} "
                                 f"corners, not max_patches={p.max_patches} (the CPU takes any)")
            if not 0 <= p.lk_radius <= frame_rows_kernel.MAX_RADIUS:
                raise ValueError(f"the LK kernel tracks with a radius of 0 to "
                                 f"{frame_rows_kernel.MAX_RADIUS}, not lk_radius={p.lk_radius} "
                                 "(the CPU takes any)")
        self.height = height
        self.width = width
        cap = self.params.capacity
        self.mesh = mesh
        self._group = None
        self._rows = slice(0, cap)
        if mesh is not None:
            self._group = dmesh.table_group(mesh)
            n = self._group.size()
            if cap % n:
                raise ValueError(f"the table's {cap} rows do not split over the {n} "
                                 "ranks of the mesh")
            lin = dmesh.block_index(mesh)
            self._rows = slice(lin * cap // n, (lin + 1) * cap // n)
        self.table = ps.empty_table(self._rows.stop - self._rows.start, device=self.device)
        self.grads = torch.zeros((cap, 2, height, width), dtype=torch.float32,
                                 device=self.device)
        self.slot_refcount = np.zeros(cap, np.int64)
        # detection-frame number each slot's gradients were written at (-1 =
        # never); drives oldest-first eviction
        self.slot_birth = np.full(cap, -1, np.int64)
        self._newest_slot = 0
        self.next_track_id = 0
        self.epoch_us: int | None = None
        # the previous frame and its pyramid (kept from its frame step; a
        # frame set from outside, as a checkpoint's resume does, has its
        # pyramid rebuilt at first use)
        self.prev_image: torch.Tensor | None = None
        self.num_images = 0
        self.trajectories: dict[int, list[tuple[int, float, float]]] = {}
        self.final_cost_log: list[tuple[int, float, int]] = []
        self.archived_tracks: set[int] = set()
        self.pstate = policy.empty_state(cap, device=self.device)
        # the newest post-frame host mirror: the keyframe build reads it
        # instead of the table
        self.last_mirror: dict | None = None

    def load_numpy_state(self, grads, slot_refcount, slot_birth,
                         next_track_id: int, epoch_us, pstate: dict | None = None):
        """Carry tracker state across from host arrays (e.g. the JAX
        tracker's gradient store and slot bookkeeping). The newest slot is
        the one with the latest birth frame. `pstate`: the device policy's
        state as numpy (`slot_birth` [SLOTS], `next_tid`, `frame_no`)."""
        if pstate is not None:
            self.pstate = policy.PolicyState(**{
                k: torch.tensor(np.asarray(pstate[k], np.int32), device=self.device)
                for k in ("slot_birth", "next_tid", "frame_no")})
        self.grads = torch.tensor(np.asarray(grads, np.float32), device=self.device)
        self.slot_refcount = np.asarray(slot_refcount, np.int64).copy()
        self.slot_birth = np.asarray(slot_birth, np.int64).copy()
        self.next_track_id = int(next_track_id)
        self.epoch_us = None if epoch_us is None else int(epoch_us)
        self._newest_slot = int(np.argmax(self.slot_birth))

    # -- frame path ------------------------------------------------------
    @property
    def prev_image(self) -> torch.Tensor | None:
        return self._prev_image

    @prev_image.setter
    def prev_image(self, img) -> None:
        self._prev_image = img
        self._prev_pyr = None

    def _set_prev(self, img, pyr) -> None:
        self._prev_image = img
        self._prev_pyr = pyr

    def prev_pyramid(self) -> tuple:
        """The previous frame's pyramid, level 0 first: the one its frame
        step made, or rebuilt from `prev_image` (`frame_maps`, one launch on
        the card) where that was set from outside."""
        if self._prev_pyr is None and self._prev_image is not None:
            img = self._prev_image
            self._prev_pyr = frame_maps.pyramid(img, frame_maps.frame_maps(img),
                                                self.params.lk_levels)
        return self._prev_pyr

    def _as_f32_image(self, image) -> torch.Tensor:
        img = torch.tensor(np.asarray(image), device=self.device)
        if img.dtype == torch.uint8:
            return img.to(torch.float32) / 255.0
        return img.to(torch.float32)

    def new_image(self, t_us: int, image: np.ndarray) -> None:
        """Per-frame path (`FeatureDetector::newImage`)."""
        p = self.params
        if self.epoch_us is None:
            self.epoch_us = int(t_us)
        img = self._as_f32_image(image)
        corners_xy, corners_valid, maps = frame_analyze(
            img, max_corners=p.max_patches, quality_level=p.quality_level,
            min_distance=p.min_distance, block_size=p.block_size,
            border=ps.PATCH_EXTENT + 1,
        )
        pulled = self._frame_read(corners_xy, corners_valid,
                                  dict(mirror=self._mirror_fields()))
        mirror = pulled["mirror"]
        self._archive_dead(mirror)
        self._dispatch_frame(t_us, img, maps, pulled["corners"], mirror)
        self._consume_framelog(t_us, self.host_mirror())

    def _frame_read(self, corners_xy, corners_valid, pull: dict) -> dict:
        """The frame's corners read back with `pull` (device tensors) in one
        copy: `pull`'s arrays as host numpy, and `corners`, the valid ones
        [C, 2] in rank order."""
        pulled = HostCopy(dict(pull, xy=corners_xy, valid=corners_valid)).get()
        pulled["corners"] = pulled.pop("xy")[pulled.pop("valid")]
        return pulled

    def _dispatch_frame(self, t_us: int, img, maps, corners: np.ndarray,
                        mirror: dict) -> None:
        """Host policy on the global mirror, then the frame's table update
        (of this rank's rows, under a mesh) with the frame's maps."""
        p = self.params
        ctrl = self._frame_policy(t_us, corners, mirror)
        dec = {k: torch.as_tensor(v if k == "slot" else v[self._rows]).to(self.device)
               for k, v in ctrl.items()}
        self.num_images += 1
        with_lk = self.prev_image is not None and self.num_images >= 2
        pyr = frame_maps.pyramid(img, maps, p.lk_levels)
        self.table = frame_apply(
            self.table, self.grads, maps[0], pyr, self.prev_pyramid() if with_lk else None,
            dec, with_lk=with_lk, lk_radius=p.lk_radius,
        )
        self._set_prev(img, pyr)

    def _frame_policy(self, t_us: int, corners: np.ndarray, mirror: dict) -> dict:
        """Host policy on the [P] mirror: gradient-slot allocation (evicting
        the oldest slot's patches when none is free), greedy association of
        corners to live patches within `association_distance`, insertion of
        the unmatched corners into free rows up to the live cap."""
        p = self.params
        alive = mirror["alive"].copy()
        centers = mirror["center"]
        P = len(alive)
        evict = np.zeros(P, bool)
        free_slots = np.flatnonzero(self.slot_refcount == 0)
        if len(free_slots):
            slot = int(free_slots[0])
        else:
            slot = int(np.argmin(self.slot_birth))
            evict = alive & (mirror["grad_slot"] == slot)
            for i in np.flatnonzero(evict):
                tid = int(mirror["track_id"][i])
                if tid >= 0 and tid not in self.archived_tracks:
                    self.archived_tracks.add(tid)
                    self.slot_refcount[mirror["grad_slot"][i]] -= 1
            alive = alive & ~evict
        self.slot_birth[slot] = self.num_images
        self._newest_slot = slot
        n_live = int(alive.sum())

        claimed = np.zeros(len(corners), bool)
        for i in np.flatnonzero(alive):
            d = np.linalg.norm(corners - centers[i], axis=-1) if len(corners) else []
            for j in np.argsort(d) if len(corners) else []:
                if not claimed[j] and d[j] < p.association_distance:
                    claimed[j] = True
                    break

        new_mask = np.zeros(P, bool)
        new_center = np.zeros((P, 2), np.float32)
        new_tid = np.full(P, -1, np.int32)
        free_rows = np.flatnonzero(~alive)
        budget = max(0, p.max_patches - n_live)
        k = 0
        for j in np.flatnonzero(~claimed) if len(corners) else []:
            if k >= min(budget, len(free_rows)):
                break
            row = free_rows[k]
            new_mask[row] = True
            new_center[row] = corners[j]
            new_tid[row] = self.next_track_id
            self.trajectories[self.next_track_id] = [
                (int(t_us), float(corners[j][0]), float(corners[j][1]))
            ]
            self.next_track_id += 1
            self.slot_refcount[slot] += 1
            k += 1
        return dict(new_mask=new_mask, new_tid=new_tid, new_center=new_center,
                    evict=evict, slot=np.int64(slot))

    def _consume_framelog(self, t_us: int, mirror: dict) -> None:
        """Lifecycle + one trajectory entry per live patch for this frame. A
        centre that is not finite (a corrupted row, which the watchdog
        quarantines) is not logged."""
        self._archive_dead(mirror)
        idx = np.flatnonzero(mirror["alive"] & np.isfinite(mirror["center"]).all(-1))
        if len(idx):
            t = int(t_us)
            tids = mirror["track_id"][idx].tolist()
            centers = mirror["center"][idx].astype(np.float64)
            for tid, cx, cy in zip(tids, centers[:, 0].tolist(), centers[:, 1].tolist()):
                self.trajectories.setdefault(tid, []).append((t, cx, cy))
        self.last_mirror = mirror

    def _archive_dead(self, mirror: dict) -> None:
        """Archive lost patches once each: refcount their gradient slot down
        and record the track id."""
        dead = (~mirror["alive"]) & (mirror["track_id"] >= 0)
        for i in np.flatnonzero(dead):
            tid = int(mirror["track_id"][i])
            if tid in self.archived_tracks:
                continue
            self.archived_tracks.add(tid)
            self.slot_refcount[mirror["grad_slot"][i]] -= 1
        self.slot_refcount = np.maximum(self.slot_refcount, 0)

    # -- event path ------------------------------------------------------
    def process_events(self, t_us: np.ndarray, x: np.ndarray, y: np.ndarray,
                       pol: np.ndarray) -> None:
        """Feed a window of time-ordered host events: route them to patches
        and solve, sub-batch by sub-batch."""
        if len(t_us) == 0:
            return
        events, k = self._upload_window(t_us, x, y, pol)
        pulled = HostCopy(self._scan_and_mirror(events)).get()
        self._log_scan(pulled["stacked"], k)
        self._archive_dead(pulled["mirror"])

    def _scan_and_mirror(self, events) -> dict:
        """Scan a window (on this rank's rows, under a mesh) and return its
        global stacked log and post-scan mirror, as device tensors gathered
        in one collective."""
        latest = self.grads[self._newest_slot]
        self.table, stacked, mirror = sharded_window_scan(
            self._group, self.table, self.grads, *events, latest, mirror=ps.MIRROR_FIELDS)
        return dict(stacked=stacked, mirror=mirror)

    def _upload_window(self, t_us, x, y, pol):
        """Cut, pack and upload a window: ((ex, ey, et, ep, mask) [K, C] on
        the device, K)."""
        bounds, cap = self._subbatch_bounds(t_us)
        xyp, trel, offset, k = self._window_batches(t_us, x, y, pol, bounds, cap)
        dev = self.device
        return unpack_events(
            torch.as_tensor(xyp).to(dev), torch.as_tensor(trel).to(dev),
            torch.tensor(offset, dtype=torch.float32, device=dev),
        ), k

    # -- frame-window path (the pipelined drive) -------------------------
    def process_frame_window(self, t_us, x, y, pol, img_t_us: int,
                             image: np.ndarray):
        """One frame window: its events (scan) and its frame (analysis,
        policy, table update) in one call. The post-frame state is not read
        here: it comes back as a handle whose copy to the host is already
        queued behind this window's work, and the caller reads it later
        (`consume_frames`), typically while the device runs the next window.

        Returns (frame_t_us, handle): pass both to `consume_frame`."""
        p = self.params
        if self.epoch_us is None:
            self.epoch_us = int(img_t_us if len(t_us) == 0 else t_us[0])
        img = self._as_f32_image(image)
        if p.device_policy:
            return self._process_frame_window_fused(t_us, x, y, pol, img_t_us, img)
        corners_xy, corners_valid, maps = frame_analyze(
            img, max_corners=p.max_patches, quality_level=p.quality_level,
            min_distance=p.min_distance, block_size=p.block_size,
            border=ps.PATCH_EXTENT + 1,
        )
        k = 0
        if len(t_us):
            events, k = self._upload_window(t_us, x, y, pol)
            pull = self._scan_and_mirror(events)
        else:
            pull = dict(mirror=self._mirror_fields())
        # one read serves the scan log, the pre-frame mirror and the corners
        pulled = self._frame_read(corners_xy, corners_valid, pull)
        mirror = pulled.pop("mirror")
        corners = pulled.pop("corners")
        self._archive_dead(mirror)
        self._dispatch_frame(img_t_us, img, maps, corners, mirror)
        # the scan log is on the host already, but it is applied when the
        # handle is consumed, so that a track's scan and frame entries are
        # logged in time order whatever the number of windows in flight
        return int(img_t_us), FrameHandle({"mirror": self._mirror_fields()}, k, pulled)

    # -- the global table (one block of it per rank under a mesh) ---------
    def _gather(self, tree: dict) -> dict:
        """The [P_local, ...] tensors of `tree`, this rank's rows, with the
        global rows (one collective under a mesh; as they are without one)."""
        return dmesh.gather_rows(tree, self._group)

    def _mirror_fields(self) -> dict:
        """The mirror's fields of the global table, as device tensors."""
        return self._gather({k: getattr(self.table, k) for k in ps.MIRROR_FIELDS})

    def host_mirror(self) -> dict:
        """The small control fields of the global table as host numpy."""
        return HostCopy(self._mirror_fields()).get()

    def global_table(self) -> ps.PatchTable:
        """The whole table: under a mesh, every rank's block in block order
        (one collective, every rank must call it); else `table` itself."""
        return ps.PatchTable(**self._gather(
            {k: getattr(self.table, k) for k in ps.FIELDS}))

    def set_global_table(self, table: ps.PatchTable) -> None:
        """Take the whole table `table`: this rank keeps its block of rows."""
        self.table = ps.PatchTable(**{k: self.local_rows(getattr(table, k))
                                      for k in ps.FIELDS})

    def local_rows(self, a):
        """This rank's rows of a global [P, ...] array (all of them without a
        mesh)."""
        return a[self._rows]

    def _process_frame_window_fused(self, t_us, x, y, pol, img_t_us: int, img):
        """`process_frame_window` with the policy on the device: nothing of
        the frame's decisions is read back here; they are in the handle's
        frame log."""
        p = self.params
        events, k = self._upload_window(t_us, x, y, pol) if len(t_us) else (None, 0)
        self.num_images += 1
        with_lk = self.prev_image is not None and self.num_images >= 2
        kw = dict(with_lk=with_lk, lk_levels=p.lk_levels, lk_radius=p.lk_radius,
                  max_corners=p.max_patches, quality_level=p.quality_level,
                  min_distance=p.min_distance, block_size=p.block_size,
                  border=ps.PATCH_EXTENT + 1, max_patches=p.max_patches,
                  association_distance=p.association_distance)
        prev = self.prev_pyramid() if with_lk else None
        self.table, self.pstate, stacked, framelog, pyr = sharded_fused_step(
            self._group, self._rows, self.table, self.grads, self.pstate, events,
            img, prev, **kw)
        self._set_prev(img, pyr)
        out = {"framelog": framelog}
        if stacked is not None:
            out["stacked"] = stacked
        return int(img_t_us), FrameHandle(out, k)

    def consume_frames(self, items: list) -> list:
        """Consume several `process_frame_window` handles, [(frame_t_us,
        handle)] in dispatch order. Returns the post-frame mirrors."""
        return [self.consume_frame(t_us, h) for t_us, h in items]

    def consume_frame(self, frame_t_us: int, handle) -> dict:
        """Wait for a `process_frame_window` handle (its copy has usually
        landed) and apply the deferred host bookkeeping; returns the
        post-frame mirror (the keyframe input for VO)."""
        pulled = handle.get()
        if "framelog" in pulled:
            return self._consume_fused_pulled(frame_t_us, pulled, handle.k)
        if "stacked" in pulled:
            self._log_scan(pulled["stacked"], handle.k)
        self._consume_framelog(frame_t_us, pulled["mirror"])
        return pulled["mirror"]

    def _consume_fused_pulled(self, frame_t_us: int, pulled: dict, k: int) -> dict:
        """Host bookkeeping for one fused window's log."""
        if "stacked" in pulled:
            st = pulled["stacked"]
            self._log_scan(st, k)
            # a patch lost in the scan whose row the frame reused at once is
            # in no post-frame mirror: archive it from the scan's last step
            gone = ~st["alive"][k - 1] & (st["track_id"][k - 1] >= 0)
            self.archived_tracks.update(st["track_id"][k - 1][gone].tolist())
        fl = pulled["framelog"]
        # patches evicted by slot reclamation: their rows may have been
        # reused for new detections in the same frame
        for tid in fl["evict_tid"][fl["evict_tid"] >= 0]:
            self.archived_tracks.add(int(tid))
        for r in np.flatnonzero(fl["new_mask"]):
            tid = int(fl["new_tid"][r])
            cx, cy = fl["new_center"][r]
            self.trajectories[tid] = [(int(frame_t_us), float(cx), float(cy))]
            # the host allocator follows the device's, so both policies
            # agree on the next id
            self.next_track_id = max(self.next_track_id, tid + 1)
        mirror = {kk: fl[kk] for kk in FRAMELOG_MIRROR}
        self._consume_framelog(frame_t_us, mirror)
        return mirror

    def _subbatch_bounds(self, t_us):
        """Cut a window into sub-batches bounded by count and duration.
        A window denser than max_window_steps * sub_batch_events scales both
        bounds so that it takes about max_window_steps steps. Returns
        (bounds, cap), cap being the width to pack at."""
        p = self.params
        n = len(t_us)
        cap = p.sub_batch_events
        dur = p.sub_batch_duration_us
        if p.max_window_steps and n > cap * p.max_window_steps:
            cap = -(-n // p.max_window_steps)
            cap = 4096 * -(-cap // 4096)
            span = int(t_us[-1]) - int(t_us[0]) + 1
            dur = max(dur, -(-span // p.max_window_steps))
        bounds = []
        lo = 0
        while lo < n:
            hi_cnt = min(lo + cap, n)
            hi_time = int(np.searchsorted(t_us, t_us[lo] + dur, "left"))
            hi = max(lo + 1, min(hi_cnt, hi_time))
            bounds.append((lo, hi))
            lo = hi
        return bounds, cap

    def _window_batches(self, t_us, x, y, pol, bounds, cap: int):
        """Pack the sub-batches: [K, C] int32 xyp + int32 µs relative time +
        one f32 window offset."""
        if self.epoch_us is None:
            self.epoch_us = int(t_us[0])
        k = len(bounds)
        t0_us = int(t_us[0])
        xyp = np.full((k, cap), -1, np.int32)
        trel = np.zeros((k, cap), np.int32)
        for i, (lo, hi) in enumerate(bounds):
            m = hi - lo
            xi = np.asarray(x[lo:hi], np.int32)
            yi = np.asarray(y[lo:hi], np.int32)
            pi = (np.asarray(pol[lo:hi]) > 0).astype(np.int32)
            xyp[i, :m] = xi | (yi << _XY_BITS) | (pi << (2 * _XY_BITS))
            trel[i, :m] = (t_us[lo:hi] - t0_us).astype(np.int32)
        offset = np.float32((t0_us - self.epoch_us) / US_PER_S)
        return xyp, trel, offset, k

    def _log_scan(self, stacked: dict, k: int) -> None:
        """Final-cost rows and trajectory extensions from the scan's [K, P]
        log, in (step, row) order; per track in step order."""
        ran = stacked["ran"][:k]
        if not ran.any():
            return
        step_i, row_i = np.nonzero(ran)
        tid = stacked["track_id"][:k][step_i, row_i]
        keep = tid >= 0
        if not keep.all():
            step_i, row_i, tid = step_i[keep], row_i[keep], tid[keep]
        if len(tid) == 0:
            return
        cost = stacked["cost"][:k][step_i, row_i].astype(np.float64)
        cur_t = stacked["cur_t"][:k][step_i, row_i].astype(np.float64)
        # np.rint rounds half to even
        t_abs = np.rint(cur_t * US_PER_S).astype(np.int64) + (self.epoch_us or 0)
        self.final_cost_log.extend(zip(tid.tolist(), cost.tolist(), t_abs.tolist()))
        live = np.flatnonzero(stacked["alive"][:k][step_i, row_i])
        if len(live) == 0:
            return
        center = stacked["center"][:k][step_i[live], row_i[live]].astype(np.float64)
        entries = list(zip(t_abs[live].tolist(), center[:, 0].tolist(),
                           center[:, 1].tolist()))
        tid_l = tid[live]
        order = np.argsort(tid_l, kind="stable")
        sorted_tid = tid_l[order]
        bounds = (np.flatnonzero(np.diff(sorted_tid)) + 1).tolist()
        ordered = order.tolist()
        st = sorted_tid.tolist()
        start = 0
        for end in bounds + [len(st)]:
            lst = self.trajectories.setdefault(st[start], [])
            lst.extend(entries[j] for j in ordered[start:end])
            start = end
