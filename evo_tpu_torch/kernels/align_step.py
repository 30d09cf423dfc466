"""The tracker's alignment step as one CUDA kernel, one block per table row.

Counterpart of `evo_tpu/tracker/align.py::optimize_ready_patches` followed
by `update_budgets_solved` (XLA device code: the JAX package has no Pallas
kernel here). For one event sub-batch, every ready row of the patch table
(`is_ready & alive & initialized`) integrates its newest events, runs the
whole alignment LM, applies the post-solve update and takes its new event
budget, in one launch; a row that is not ready keeps its state. The plain
PyTorch version is `tracker.align.solve_step_ref`, and
`tracker.align.solve_step` picks between the two by the table's device.

The kernel is `csrc/align_step.cu`, built at first use by `kernels.nvcc`
(with `-fmad=false`, so that its roundings follow the plain version's). Its
entry `align_step` takes tensors on the card only: a CPU tensor raises, as
does a failed build or launch. A row's result depends on that row's inputs
alone, never on how many rows the table holds.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from evo_tpu_torch.kernels import nvcc

# Launches of the kernel since the last reset. The compensation worker and
# the main thread launch side by side, so the count changes under a lock.
launches_align = 0
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches_align
    with _count_lock:
        launches_align = 0


def _count() -> None:
    global launches_align
    with _count_lock:
        launches_align += 1


# the table's fields the kernel reads, in the C entry's order, with dtypes
IN_FIELDS = (
    ("alive", torch.bool), ("initialized", torch.bool), ("center", torch.float32),
    ("init_pt", torch.float32), ("warp", torch.float32), ("flow", torch.float32),
    ("num_of_events", torch.int32), ("counter", torch.int32), ("ev_t", torch.float32),
    ("ev_x", torch.float32), ("ev_y", torch.float32), ("ev_p", torch.float32),
    ("ev_count", torch.int32), ("grad_slot", torch.int32),
    ("final_costs", torch.float32), ("n_costs", torch.int32), ("cur_t", torch.float32),
    ("last_update_t", torch.float32), ("time_without_update", torch.float32),
)
# the fields it writes, in the C entry's order; the others stay as they were
OUT_FIELDS = ("alive", "center", "warp", "flow", "num_of_events", "counter",
              "final_costs", "n_costs", "cur_t", "last_update_t",
              "time_without_update")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # 19 table fields, grads, latest_grad, 11 output fields, ran, lost, cost,
    # integrated (or null), trips (or null), P, E, S, H, W, stream
    "evo_align_step": ([_P] * (len(IN_FIELDS) + 2 + len(OUT_FIELDS) + 5)
                       + [_I] * 5 + [_P], _I),
}
_lib_handle = None
_lib_lock = threading.Lock()


def _lib():
    """The compiled kernel (built from csrc/align_step.cu at first use)."""
    global _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            _lib_handle = nvcc.load("evo_align_step", ["align_step.cu"], _SIGNATURES,
                                    extra_flags=("-fmad=false",))
    return _lib_handle


def _check(table, grads, latest_grad) -> None:
    dev = table.center.device
    if dev.type != "cuda":
        raise RuntimeError(
            f"align_step has no kernel for device {dev}: the plain version is "
            "tracker.align.solve_step_ref (tracker.align.solve_step picks it for a "
            "table on the CPU)")
    p, e = table.ev_t.shape
    shapes = dict(center=(p, 2), init_pt=(p, 2), warp=(p, 4), final_costs=(p, 5),
                  ev_t=(p, e), ev_x=(p, e), ev_y=(p, e), ev_p=(p, e))
    for name, dtype in IN_FIELDS:
        t = getattr(table, name)
        if t.dtype != dtype:
            raise TypeError(f"table.{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shapes.get(name, (p,)):
            raise ValueError(f"table.{name} has shape {tuple(t.shape)}, "
                             f"not {shapes.get(name, (p,))}")
        if not t.is_contiguous():
            raise ValueError(f"table.{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"table.{name} is on {t.device}, not on {dev}")
    if (grads.dim() != 4 or grads.shape[1] != 2
            or tuple(latest_grad.shape) != (2, *grads.shape[2:])):
        raise ValueError(f"grads must be [S, 2, H, W] and latest_grad [2, H, W]; got "
                         f"{tuple(grads.shape)}, {tuple(latest_grad.shape)}")
    for name, t in (("grads", grads), ("latest_grad", latest_grad)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous float32 on {dev}")
    if min(grads.shape[2:]) < 64:
        raise ValueError(f"the image {tuple(grads.shape[2:])} is smaller than the "
                         "64 x 64 gradient window")


def align_step(table, grads, latest_grad, *, integrated: bool = False,
               trips: bool = False):
    """One launch over the P rows of `table` (a `tracker.patch_state.PatchTable`
    on the card) against the gradient store grads [S, 2, H, W] and the newest
    gradient pair latest_grad [2, H, W].

    Returns (fields, ran, cost, lost, extra): `fields` maps each name of
    `OUT_FIELDS` to a new tensor (the table is not written); ran and lost
    [P] bool and cost [P] (½·cost of the rows that solved, 0 elsewhere) as
    `optimize_ready_patches` logs them. `extra` holds, when asked for, the
    integrated event images [P, 25, 25] of the rows that solved (zeros
    elsewhere) and the LM trips [P] int32 of each row.
    """
    _check(table, grads, latest_grad)
    p, e = table.ev_t.shape
    dev = table.center.device
    fields = {name: torch.empty_like(getattr(table, name)) for name in OUT_FIELDS}
    ran = torch.empty(p, dtype=torch.bool, device=dev)
    lost = torch.empty(p, dtype=torch.bool, device=dev)
    cost = torch.empty(p, dtype=torch.float32, device=dev)
    extra = {}
    if integrated:
        extra["integrated"] = torch.zeros(p, 25, 25, dtype=torch.float32, device=dev)
    if trips:
        extra["trips"] = torch.empty(p, dtype=torch.int32, device=dev)
    ptrs = [getattr(table, name).data_ptr() for name, _ in IN_FIELDS]
    ptrs += [grads.data_ptr(), latest_grad.data_ptr()]
    ptrs += [fields[name].data_ptr() for name in OUT_FIELDS]
    ptrs += [ran.data_ptr(), lost.data_ptr(), cost.data_ptr()]
    ptrs += [extra[k].data_ptr() if k in extra else None for k in ("integrated", "trips")]
    nvcc.launch(_lib().evo_align_step, table.center, *ptrs, p, e, grads.shape[0],
                grads.shape[2], grads.shape[3])
    _count()
    return fields, ran, cost, lost, extra
