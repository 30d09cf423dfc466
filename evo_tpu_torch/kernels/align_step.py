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

A call allocates once: every output is a typed view of one byte arena, and
the C entry takes the kernel's pointers as one array (`POINTERS`), so the
host's work per call is one `torch.empty` and one ctypes call.
"""

from __future__ import annotations

import array
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


# the table's fields the kernel reads, in the kernel's order, with dtypes
IN_FIELDS = (
    ("alive", torch.bool), ("initialized", torch.bool), ("center", torch.float32),
    ("init_pt", torch.float32), ("warp", torch.float32), ("flow", torch.float32),
    ("num_of_events", torch.int32), ("counter", torch.int32), ("ev_t", torch.float32),
    ("ev_x", torch.float32), ("ev_y", torch.float32), ("ev_p", torch.float32),
    ("ev_count", torch.int32), ("grad_slot", torch.int32),
    ("final_costs", torch.float32), ("n_costs", torch.int32), ("cur_t", torch.float32),
    ("last_update_t", torch.float32), ("time_without_update", torch.float32),
)
# the fields it writes, in the kernel's order; the others stay as they were
OUT_FIELDS = ("alive", "center", "warp", "flow", "num_of_events", "counter",
              "final_costs", "n_costs", "cur_t", "last_update_t",
              "time_without_update")
# the log outputs, then those only made when asked for
LOG_OUTPUTS = ("ran", "lost", "cost")
EXTRA_OUTPUTS = ("integrated", "trips", "clocks")
# the entry's pointer array, in the order of csrc/align_step.cu's `Args`
POINTERS = ([n for n, _ in IN_FIELDS] + ["grads", "latest_grad"]
            + [f + "_out" for f in OUT_FIELDS + LOG_OUTPUTS + EXTRA_OUTPUTS])
# stages of the clock build's [P, 8] int64 output, in the kernel's order
STAGES = ("prologue", "step", "sample", "reduce1", "reduce2", "accept", "rebudget", "total")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # the address of the pointer array (`POINTERS`), P, E, S, H, W, stream
    "evo_align_step": ([_P] + [_I] * 5 + [_P], _I),
}
_IN_NAMES = tuple(n for n, _ in IN_FIELDS)
_IN_DTYPES = [d for _, d in IN_FIELDS]
_libs: dict[bool, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def _lib(clocks: bool = False):
    """The compiled kernel (built from csrc/align_step.cu at first use); with
    `clocks`, its clock build (-DEVO_ALIGN_CLOCKS), a library of its own."""
    with _lib_lock:
        if clocks not in _libs:
            name, flags = "evo_align_step", ("-fmad=false",)
            if clocks:
                name, flags = name + "_clock", flags + ("-DEVO_ALIGN_CLOCKS",)
            _libs[clocks] = nvcc.load(name, ["align_step.cu"], _SIGNATURES, extra_flags=flags,
                                      headers=("row_budget.cuh",))
        return _libs[clocks]


def _in_shapes(p: int, e: int) -> list:
    shapes = dict(center=(p, 2), init_pt=(p, 2), warp=(p, 4), final_costs=(p, 5),
                  ev_t=(p, e), ev_x=(p, e), ev_y=(p, e), ev_p=(p, e))
    return [torch.Size(shapes.get(n, (p,))) for n in _IN_NAMES]


_in_shapes_cache: dict[tuple, list] = {}


def _check(table, grads, latest_grad) -> list:
    """The table's input tensors, in `IN_FIELDS` order, once they are known
    to be what the kernel reads; raises otherwise."""
    dev = table.center.device
    if dev.type != "cuda":
        raise RuntimeError(
            f"align_step has no kernel for device {dev}: the plain version is "
            "tracker.align.solve_step_ref (tracker.align.solve_step picks it for a "
            "table on the CPU)")
    ins = [getattr(table, n) for n in _IN_NAMES]
    p, e = table.ev_t.shape
    shapes = _in_shapes_cache.get((p, e))
    if shapes is None:
        shapes = _in_shapes_cache.setdefault((p, e), _in_shapes(p, e))
    index = dev.index
    if not ([t.dtype for t in ins] == _IN_DTYPES and [t.shape for t in ins] == shapes
            and all([t.is_contiguous() and t.get_device() == index for t in ins])):
        for (name, dtype), t, shape in zip(IN_FIELDS, ins, shapes):
            if t.dtype != dtype:
                raise TypeError(f"table.{name} must be {dtype}, got {t.dtype}")
            if t.shape != shape:
                raise ValueError(f"table.{name} has shape {tuple(t.shape)}, not {tuple(shape)}")
            if not t.is_contiguous():
                raise ValueError(f"table.{name} must be contiguous")
            if t.device != dev:
                raise ValueError(f"table.{name} is on {t.device}, not on {dev}")
    if (grads.dim() != 4 or grads.shape[1] != 2
            or latest_grad.shape != (2, *grads.shape[2:])):
        raise ValueError(f"grads must be [S, 2, H, W] and latest_grad [2, H, W]; got "
                         f"{tuple(grads.shape)}, {tuple(latest_grad.shape)}")
    for name, t in (("grads", grads), ("latest_grad", latest_grad)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.get_device() != index:
            raise ValueError(f"{name} must be contiguous float32 on {dev}")
    if grads.shape[2] < 64 or grads.shape[3] < 64:
        raise ValueError(f"the image {tuple(grads.shape[2:])} is smaller than the "
                         "64 x 64 gradient window")
    return ins


# The output arena, in float32 words: the int64 clocks if asked for (first,
# so 8-byte aligned), each float32 output, then one block of the int32
# outputs and one of the bools (as bytes, four rows to a row of words, the
# fourth unused). One `split_with_sizes` cuts it; only the outputs of more
# than one column, and the two blocks, take a view more.
_FLOATS = (("center", 2), ("warp", 4), ("final_costs", 5), ("integrated", (25, 25)),
           ("flow", 0), ("cur_t", 0), ("last_update_t", 0), ("time_without_update", 0),
           ("cost", 0))
_INTS = ("num_of_events", "counter", "n_costs", "trips")
_BOOLS = ("alive", "ran", "lost")


def _layout(p: int, extras: tuple) -> tuple:
    """The arena of p rows: its length in words; the sizes of its parts;
    the float32 outputs' names with the shape each part takes (None: [p]
    as cut); the int32 outputs' names; the row sizes of the int32 and the
    bool blocks; and the byte offset of each output pointer of `POINTERS`
    (None: not made)."""
    def made(n):
        return n not in EXTRA_OUTPUTS or n in extras

    floats = [(n, None if c == 0 else (p, *c) if isinstance(c, tuple) else (p, c))
              for n, c in _FLOATS if made(n)]
    ints = [n for n in _INTS if made(n)]
    sizes = [2 * p * len(STAGES)] if made("clocks") else []
    sizes += [p if shape is None else int(torch.Size(shape).numel()) for _, shape in floats]
    sizes += [len(ints) * p, p]
    rows = ([p] * len(ints), [p] * 4)
    starts = [4 * sum(sizes[:k]) for k in range(len(sizes))]
    at = {"clocks": 0} if made("clocks") else {}
    at.update({n: starts[len(sizes) - len(floats) - 2 + k] for k, (n, _) in enumerate(floats)})
    at.update({n: starts[-2] + 4 * p * k for k, n in enumerate(ints)})
    at.update({n: starts[-1] + p * k for k, n in enumerate(_BOOLS)})
    offsets = [at.get(n[:-4]) for n in POINTERS[len(IN_FIELDS) + 2:]]
    return sum(sizes), sizes, floats, ints, rows, offsets


_layouts: dict[tuple, tuple] = {}


def _run(fn, table, ins, grads, latest_grad, extras: tuple, launch) -> dict:
    """Allocate the outputs of one launch in one arena on the table's
    device, pack the pointers into one array and call `launch(fn, its
    address, P, E, S, H, W)`. Returns the outputs by name."""
    p, e = table.ev_t.shape
    layout = _layouts.get((p, extras))
    if layout is None:
        layout = _layouts.setdefault((p, extras), _layout(p, extras))
    words, sizes, floats, ints, rows, offsets = layout
    arena = torch.empty(words, dtype=torch.float32, device=table.center.device)
    parts = arena.split_with_sizes(sizes)
    outs = {}
    if "clocks" in extras:
        outs["clocks"] = parts[0].view(torch.int64).view(p, len(STAGES))
    for (name, shape), t in zip(floats, parts[len(sizes) - len(floats) - 2:]):
        outs[name] = t if shape is None else t.view(shape)
    outs.update(zip(ints, parts[-2].view(torch.int32).split_with_sizes(rows[0])))
    outs.update(zip(_BOOLS, parts[-1].view(torch.bool).split_with_sizes(rows[1])))
    base = arena.data_ptr()
    ptrs = array.array("Q", [t.data_ptr() for t in ins])
    ptrs.append(grads.data_ptr())
    ptrs.append(latest_grad.data_ptr())
    ptrs.extend([0 if o is None else base + o for o in offsets])
    launch(fn, ptrs.buffer_info()[0], p, e, grads.shape[0], grads.shape[2], grads.shape[3])
    return outs


def align_step(table, grads, latest_grad, *, integrated: bool = False,
               trips: bool = False, clocks: bool = False):
    """One launch over the P rows of `table` (a `tracker.patch_state.PatchTable`
    on the card) against the gradient store grads [S, 2, H, W] and the newest
    gradient pair latest_grad [2, H, W].

    Returns (fields, ran, cost, lost, extra): `fields` maps each name of
    `OUT_FIELDS` to a new tensor (the table is not written); ran and lost
    [P] bool and cost [P] (½·cost of the rows that solved, 0 elsewhere) as
    `optimize_ready_patches` logs them. `extra` holds, when asked for, the
    integrated event images [P, 25, 25] of the rows that solved (zeros
    elsewhere) and the LM trips [P] int32 of each row; with `clocks`, the
    clock build runs and `extra["clocks"]` holds each row's cycles by stage
    [P, 8] int64 (`STAGES`).
    """
    ins = _check(table, grads, latest_grad)
    extras = tuple(n for n, on in zip(EXTRA_OUTPUTS, (integrated, trips, clocks)) if on)
    outs = _run(_lib(clocks).evo_align_step, table, ins, grads, latest_grad, extras,
                lambda fn, *args: nvcc.launch(fn, table.center, *args))
    _count()
    fields = {n: outs[n] for n in OUT_FIELDS}
    return fields, outs["ran"], outs["cost"], outs["lost"], {n: outs[n] for n in extras}
