"""Contrast compensation's LM step as one CUDA kernel, one block per window.

Counterpart of `evo_tpu/tracker/compensate.py::solve_motion_field`'s
`step` inside its `jax.lax.while_loop` (XLA device code: the JAX package has
no Pallas kernel here). Two entries of `csrc/comp_step.cu`, built at first
use by `kernels.nvcc` with `-fmad=false`:

- `solve(jj, jr, w2, d, lam, edges)`: the damped banded normal system of
  W windows, solved; the plain version is
  `tracker.compensate.tile_system_ref`, and `tracker.compensate.tile_system`
  picks between the two by the tensors' device. The space-sharded solve's
  root calls it.
- `LmLoop`: the unmeshed LM's state on the card, one arena, and `step(mode)`,
  one launch that folds the tail of a trip (the candidate's cost, the
  accept, the damping, the stop) with the head of the next (the TV
  weights, the solve, the next candidate). The plain version is
  `tracker.compensate.lm_step_ref`. A window that has stopped is left as it
  is, so the host may queue trips past the stop and read the stop flag only
  now and then.

Both read the TV edges as `Edges` lays them out, built once per grid
(`tracker.compensate.grid_edges`). `LmLoop(..., clocks=True)` launches the
clock build instead (`-DEVO_COMP_CLOCKS`, a library of its own, on no path of
the program): the same state, and each window's `clock64()` cycles by stage
(`STAGES`) of the last launch in `LmLoop.clocks`. Tensors on the card only: a
CPU tensor raises, as does a failed build or launch. A window's result
depends on that window's inputs alone.
"""

from __future__ import annotations

import array
import ctypes
import threading

import numpy as np
import torch

from evo_tpu_torch.kernels import nvcc

# the largest band csrc/comp_step.cu takes; its bands 12 and 24 (the main
# path's grids of 6 and 12 tile columns) run in one warp's registers, the
# others over the block
MAX_BAND = 64
INIT, TAIL, HEAD = 1, 2, 4

# Launches of each entry since the last reset, under a lock (the
# compensation worker launches beside the main thread).
launches_solve = 0
launches_step = 0
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches_solve, launches_step
    with _count_lock:
        launches_solve = 0
        launches_step = 0


def _count(name: str) -> None:
    with _count_lock:
        globals()[name] += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # jj, jr, w2, d, lam, p, q, start, inc, delta, ok, W, T, E, band, stream
    "evo_comp_solve": ([_P] * 11 + [_I] * 4 + [_P], _I),
    # pointers (`STATE`), p, q, start, inc, W, T, E, band, mode, tv_weight,
    # tv_huber, stream
    "evo_comp_lm_step": ([_P] * 5 + [_I] * 5 + [_F] * 2 + [_P], _I),
}
# the loop's state, in the order of csrc/comp_step.cu's `LmState`: the
# float32 parts with their trailing shapes, then the int32 parts ([W] each)
FLOAT_STATE = (("v", (2,)), ("v_new", (2,)), ("r", ()), ("J", (2,)), ("r_new", ()),
               ("J_new", (2,)), ("lam", None), ("cost", None), ("cost0", None))
INT_STATE = ("active", "bad", "iters")
# stages of the clock build's [W, len(STAGES)] int64 output, in the kernel's
# order (csrc/comp_step.cu's `Stage`)
STAGES = ("init", "tail", "weights", "assemble", "pivot", "column", "update", "exchange", "back",
          "candidate", "total")
_libs: dict = {}
_lib_lock = threading.Lock()


def _lib(clocks: bool = False):
    """The compiled kernels (built from csrc/comp_step.cu at first use); with
    `clocks`, their clock build (-DEVO_COMP_CLOCKS), a library of its own."""
    with _lib_lock:
        if clocks not in _libs:
            name, flags = "evo_comp_step", ("-fmad=false",)
            if clocks:
                name, flags = name + "_clock", flags + ("-DEVO_COMP_CLOCKS",)
            _libs[clocks] = nvcc.load(name, ["comp_step.cu"], _SIGNATURES, extra_flags=flags)
        return _libs[clocks]


class Edges:
    """The TV edges of a system of T tiles, edge e joining tiles p[e] and
    q[e] (host arrays [E]), as the kernels and the plain versions read them
    on `device`: p, q [E] int64; `band`, the system's half-bandwidth (2 max
    |p - q|, at least 1: 24 on the 12 x 9 grid), known without a read from
    the card; and the edges at each tile (csrc/comp_step.cu's `Incidence`):
    start [T + 1] and inc [2 E] int32, inc holding 2 e + role for tile t's
    edges in [start[t], start[t + 1]), first those with p = t in edge order,
    then those with q = t."""

    def __init__(self, p, q, t: int, device):
        p, q = np.asarray(p, np.int64).reshape(-1), np.asarray(q, np.int64).reshape(-1)
        e = len(p)
        self.t = t
        self.band = max(1, 2 * int(np.abs(p - q).max())) if e else 1
        tiles = np.concatenate([p, q])
        role = np.repeat([0, 1], e)
        edge = np.tile(np.arange(e), 2)
        order = np.argsort(tiles * (2 * e) + role * e + edge)
        start = np.zeros(t + 1, np.int64)
        start[1:] = np.cumsum(np.bincount(tiles, minlength=t))

        def to(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device)

        self.p, self.q = to(p), to(q)
        self.start, self.inc = to(start.astype(np.int32)), to((2 * edge + role)[order]
                                                               .astype(np.int32))


def _check_edges(edges: Edges, t: int, dev):
    if edges.t != t:
        raise ValueError(f"the edges are of {edges.t} tiles, not {t}")
    if not 1 <= edges.band <= min(MAX_BAND, max(1, 2 * t - 1)):
        raise ValueError(f"band {edges.band} for {t} tiles (at most {MAX_BAND})")
    if edges.p.device != dev:
        raise ValueError(f"the edges are on {edges.p.device}, not on {dev}")


def _check_card(dev, what: str):
    if dev.type != "cuda":
        raise RuntimeError(f"comp_step has no kernel for device {dev}: the plain version "
                           f"is {what}")


def solve(jj, jr, w2, d, lam, edges: Edges):
    """delta [W, T, 2] (NaN where the factorisation failed) and ok [W] bool of
    the W damped systems: jj [W, T, 2, 2], jr [W, T, 2], w2 [W, E], d [W, E,
    2], lam [W] float32 over `edges`. One launch."""
    nw, t = jr.shape[:2]
    e = edges.p.shape[0]
    dev = jr.device
    want = dict(jj=(jj, (nw, t, 2, 2)), jr=(jr, (nw, t, 2)), w2=(w2, (nw, e)),
                d=(d, (nw, e, 2)), lam=(lam, (nw,)))
    for name, (a, shape) in want.items():
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, not {shape}")
        if not a.is_contiguous() or a.device != dev:
            raise ValueError(f"{name} must be contiguous on {dev}")
    _check_edges(edges, t, dev)
    _check_card(dev, "tracker.compensate.tile_system_ref")
    fn = _lib().evo_comp_solve
    out = run_solve(lambda *args: nvcc.launch(fn, jr, *args), jj, jr, w2, d, lam, edges)
    _count("launches_solve")
    return out


def run_solve(launch, jj, jr, w2, d, lam, edges: Edges):
    """Allocate `solve`'s outputs in one arena on jr's device and call
    `launch(*the entry's arguments but the stream)`."""
    nw, t = jr.shape[:2]
    g = edges
    arena = torch.empty(nw * t * 2 + (nw + 3) // 4, dtype=torch.float32, device=jr.device)
    delta = arena[: nw * t * 2].view(nw, t, 2)
    ok = arena[nw * t * 2:].view(torch.uint8)[:nw]
    launch(jj.data_ptr(), jr.data_ptr(), w2.data_ptr(), d.data_ptr(), lam.data_ptr(),
           g.p.data_ptr(), g.q.data_ptr(), g.start.data_ptr(), g.inc.data_ptr(),
           delta.data_ptr(), ok.data_ptr(), nw, t, g.p.shape[0], g.band)
    return delta, ok.view(torch.bool)


class LmLoop:
    """The LM state of W windows of `edges.t` = T tiles on the card, in one
    arena: v,
    v_new [W, T, 2]; r, r_new [W, T]; J, J_new [W, T, 2]; lam, cost, cost0
    [W] float32; active, bad, iters [W] int32 (views, by those names).
    `step(mode)` launches one trip of the kernel over the W windows: mode is
    `INIT` (the initial cost from v, r, J), `TAIL` (accept v_new from r_new,
    J_new), each optionally `| HEAD` (the next candidate v_new). With
    `clocks`, the clock build's launches, and `clocks` [W, len(STAGES)]
    int64 holds each window's cycles by stage of the last launch that ran it."""

    def __init__(self, nw: int, edges: Edges, tv_weight: float, tv_huber: float,
                 launch=None, clocks: bool = False):
        t, dev = edges.t, edges.p.device  # the state lies with the edges
        _check_edges(edges, t, dev)
        if launch is None:  # `launch`: the tests' emulation of the kernel
            _check_card(dev, "tracker.compensate.lm_step_ref")
            fn = _lib(clocks).evo_comp_lm_step
            launch = lambda *args: nvcc.launch(fn, self.v, *args)  # noqa: E731
        sizes = [nw if tail is None else nw * t * (2 if tail else 1) for _, tail in FLOAT_STATE]
        arena = torch.empty(sum(sizes) + len(INT_STATE) * nw, dtype=torch.float32, device=dev)
        parts = arena.split_with_sizes(sizes + [len(INT_STATE) * nw])
        for (name, tail), part in zip(FLOAT_STATE, parts):
            setattr(self, name, part if tail is None else part.view(nw, t, *tail))
        ints = parts[-1].view(torch.int32)
        for k, name in enumerate(INT_STATE):
            setattr(self, name, ints[k * nw:(k + 1) * nw])
        self.clocks = (torch.zeros((nw, len(STAGES)), dtype=torch.int64, device=dev)
                       if clocks else None)
        self._ptrs = array.array("Q", [getattr(self, n).data_ptr() for n, _ in FLOAT_STATE]
                                 + [getattr(self, n).data_ptr() for n in INT_STATE]
                                 + [0 if self.clocks is None else self.clocks.data_ptr()])
        g = edges
        self._keep = (arena, g, self.clocks)
        self._args = (self._ptrs.buffer_info()[0], g.p.data_ptr(), g.q.data_ptr(),
                      g.start.data_ptr(), g.inc.data_ptr(), nw, t, g.p.shape[0], g.band)
        self._tv = (float(tv_weight), float(tv_huber))
        self._launch = launch

    def step(self, mode: int) -> None:
        self._launch(*self._args, mode, *self._tv)
        _count("launches_step")
