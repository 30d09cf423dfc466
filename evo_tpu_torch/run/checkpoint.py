"""Checkpoint and resume — counterpart of `evo_tpu/run/checkpoint.py`.

The whole pipeline state goes into one `.npz`: the patch table, the
gradient store, the slot bookkeeping, the device policy's state, the
compensation warm start and the track logs as arrays, and the rest (frame
cursor, id counters, trajectories, final costs, the VO map, keyframes and
ground-truth bookkeeping) as JSON under the key `meta`. The keys, dtypes and
JSON are the JAX package's, so a checkpoint written by either package loads
into the other; a restored `Evaluator` continues with
`run(start_frame=ev.image_num)`.

One key is the port's own: `comp.buf`, the events waiting for the next
compensation window. Without it a resumed run cuts its compensation windows
elsewhere than the uninterrupted run and ends with another motion field. The
JAX package ignores the key, and a checkpoint without it resumes with an
empty buffer, as the JAX package does.

Not saved, in either package: the VO front end's RANSAC generator, so a
resumed run draws other hypotheses and its VO poses are not those of the
uninterrupted run (the tracker's artifacts are).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from evo_tpu_torch.run.evaluator import Evaluator
from evo_tpu_torch.tracker import patch_state as ps
from evo_tpu_torch.vo.keyframe import Keyframe


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def state_dict(ev: Evaluator) -> dict:
    """The full pipeline state as numpy arrays plus the JSON `meta`. Windows
    in flight are consumed and the VO worker drained first, so the state is
    that of every frame `ev.image_num` counts."""
    ev.flush_pending()
    ev.sync_vo()
    tr = ev.tracker
    # the whole table, every rank's block under a mesh (a collective)
    state = {f"table.{k}": v for k, v in ps.table_to_numpy(tr.global_table()).items()}
    state["tracker.grads"] = _np(tr.grads)
    state["tracker.slot_refcount"] = tr.slot_refcount.copy()
    state["tracker.slot_birth"] = tr.slot_birth.copy()
    state["tracker.pstate.slot_birth"] = _np(tr.pstate.slot_birth)
    if tr.prev_image is not None:
        state["tracker.prev_image"] = _np(tr.prev_image)
    if ev._comp_warm_vel is not None:
        # the compensation warm-start chain: resumed cold, the next window
        # would start from zeros and diverge from the uninterrupted run
        state["comp.warm_vel"] = _np(ev._comp_warm_vel)
    if ev._buf_count:
        state["comp.buf"] = np.concatenate(ev._buf, axis=0)

    # one source of track ids: the host policy advances next_track_id, the
    # device policy pstate.next_tid; whichever ran last is ahead, so both
    # resume from the larger
    unified_tid = max(tr.next_track_id, int(_np(tr.pstate.next_tid)))
    meta = {
        "image_num": ev.image_num,
        "last_compensation_us": ev._last_compensation_us,
        "tracker": {
            "next_track_id": unified_tid,
            "epoch_us": tr.epoch_us,
            "num_images": tr.num_images,
            "newest_slot": tr._newest_slot,
            "pstate_next_tid": unified_tid,
            "pstate_frame_no": int(_np(tr.pstate.frame_no)),
            "trajectories": {str(k): v for k, v in tr.trajectories.items()},
            "final_cost_log": tr.final_cost_log,
            "archived_tracks": sorted(tr.archived_tracks),
        },
    }
    if ev.vo is not None:
        vo = ev.vo
        meta["vo"] = {
            "without_add": vo.without_add,
            "active_frames": {
                str(t): {
                    "pose": kf.pose.tolist(),
                    "landmarks": {str(k): v.tolist() for k, v in kf.landmarks.items()},
                }
                for t, kf in vo.active_frames.items()
            },
            "stored_poses": [kf.pose.tolist() for kf in vo.stored_frames],
            "stored_ts": [kf.t_us for kf in vo.stored_frames],
            "landmarks": {str(k): v.tolist() for k, v in vo.map.landmarks.items()},
            "observations": {str(k): v for k, v in vo.map.observations.items()},
            "gt_list": [g.tolist() for g in vo.gt_list],
            "zero_gt": vo.zero_gt.tolist() if vo.zero_gt is not None else None,
        }
    state["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    return state


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, ev: Evaluator) -> str:
    """Write `state_dict(ev)` to `path` (".npz" appended if missing);
    returns the path written."""
    out = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **state_dict(ev))
    return out


def restore_into(ev: Evaluator, state: dict) -> Evaluator:
    """Load a state dict into a freshly constructed Evaluator (same dataset
    and parameters as at save time), on the evaluator's device."""
    meta = json.loads(bytes(state["meta"]).decode())
    tr = ev.tracker
    tmeta = meta["tracker"]
    # the whole table; under a mesh the rank keeps its block of it
    tr.set_global_table(ps.table_from_numpy(
        {k: state[f"table.{k}"] for k in ps.FIELDS}, device=ev.device))
    # both allocators resume from the same counter, the larger of the two
    unified_tid = max(tmeta["next_track_id"], tmeta.get("pstate_next_tid", 0))
    tr.load_numpy_state(
        state["tracker.grads"], state["tracker.slot_refcount"],
        state["tracker.slot_birth"], unified_tid, tmeta["epoch_us"],
        pstate=dict(slot_birth=state["tracker.pstate.slot_birth"],
                    next_tid=unified_tid, frame_no=tmeta["pstate_frame_no"]))
    tr._newest_slot = tmeta["newest_slot"]
    tr.num_images = tmeta["num_images"]
    if "tracker.prev_image" in state:
        # the previous frame's pyramid is not stored: the tracker rebuilds it
        # from this frame (`EventTracker.prev_pyramid`, one `frame_maps`
        # launch on the card) when the next frame's LK needs it
        tr.prev_image = torch.tensor(np.asarray(state["tracker.prev_image"], np.float32),
                                     device=ev.device)
    tr.trajectories = {
        int(k): [tuple(e) for e in v] for k, v in tmeta["trajectories"].items()}
    tr.final_cost_log = [tuple(e) for e in tmeta["final_cost_log"]]
    tr.archived_tracks = set(tmeta["archived_tracks"])

    ev.image_num = meta["image_num"]
    ev._last_compensation_us = meta["last_compensation_us"]
    if "comp.warm_vel" in state:
        warm = np.asarray(state["comp.warm_vel"], np.float32)
        # the synchronous drive keeps the warm start on the host, the
        # pipelined one on the device (owned by the evo-comp thread)
        ev._comp_warm_vel = (torch.tensor(warm, device=ev.device) if ev.pipelined
                             else warm)
    if "comp.buf" in state:
        buf = np.asarray(state["comp.buf"], np.float64)
        ev._buf, ev._buf_count = [buf], len(buf)

    if ev.vo is not None and "vo" in meta:
        vm = meta["vo"]
        active = [
            Keyframe(t_us=int(t),
                     landmarks={int(k): np.asarray(v) for k, v in d["landmarks"].items()},
                     pose=np.asarray(d["pose"]))
            for t, d in vm["active_frames"].items()]
        stored = [Keyframe(t_us=int(t), landmarks={}, pose=np.asarray(p))
                  for t, p in zip(vm["stored_ts"], vm["stored_poses"])]
        gt_list = [np.asarray(g) for g in vm["gt_list"]]
        ev.vo.load_numpy_state(
            active, stored,
            landmarks={int(k): np.asarray(v) for k, v in vm["landmarks"].items()},
            observations={int(k): list(v) for k, v in vm["observations"].items()},
            stored_landmarks=[], without_add=vm["without_add"],
            gt_list=gt_list, gt_aligned=gt_list,
            zero_gt=None if vm["zero_gt"] is None else np.asarray(vm["zero_gt"]))
    return ev


def load_checkpoint(path: str, dataset, params=None, device=None) -> Evaluator:
    """A new Evaluator on `device` (None: the card when there is one) with
    the state of the checkpoint at `path`."""
    with np.load(_npz_path(path)) as z:
        state = {k: z[k] for k in z.files}
    return restore_into(Evaluator(dataset, params, device=device), state)
