"""The alignment kernel's source, `evo_tpu_torch/csrc/align_step.cu`, run on
the CPU: compiled by g++ against the stand-in CUDA headers under
`tests/cuda_emulator/` (a std::thread for each CUDA thread, a std::barrier
for `__syncthreads`, barriers of the warp around the shuffles, a mutex for
`atomicAdd`, the grid's blocks one after another), called through the
wrapper's own pointer array and output arena (`kernels.align_step._run`),
and held to the plain version `tracker.align.solve_step_ref` on the same
CPU tensors; and its clock build (-DEVO_ALIGN_CLOCKS) held to the plain
build.

Bars: those of `tests/test_torch_align_step.py` (`torch_align_tables.
assert_same_step`, `WEAK_ROWS` included): the kernel sums the 625 rect
pixels in another order than the plain version's batched reductions, and
the LM carries that noise along flat directions of the cost. ran and lost
equal, the integrated event images exact (a sum of +-1), LM trips at least
1 where a row ran and 0 elsewhere. A row's result must not depend on the
rows launched beside it: rows 0-3 alone give the bits they give in the
8-row launch.

The emulation checks the kernel's logic and arithmetic, not its speed or
its use of the card: g++ rounds each operation as `nvcc -fmad=false` does,
but `sinf`, `cosf` and `sincosf` are glibc's, not CUDA's, and the card's
approximate reciprocals (`__fdividef`, `rsqrtf`), which the kernel refines
to IEEE quotients and roots, are exact ones here.
"""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from evo_tpu_torch.dist import multihost
from evo_tpu_torch.kernels import align_step as kalign
from evo_tpu_torch.tracker import align as talign
from evo_tpu_torch.tracker import patch_state as tps
import torch_align_tables as tables

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(kalign.__file__), "..", "csrc", "align_step.cu")


def _emulated_source(src: str) -> str:
    """The source with each `kernel<<<grid, block, smem, stream>>>(args);`
    made a call of the stand-in's `evo_emu::launch`."""
    out, n = re.subn(r"(\w+)<<<(.*?)>>>\((.*?)\);",
                     r"evo_emu::launch(\2, [&] { \1(\3); });", src, flags=re.S)
    assert n >= 1, "no kernel launch found"
    return out


def _compile(tmp, *defines):
    """The kernel's library compiled for the CPU, its entry typed as the
    wrapper types it."""
    with open(SOURCE) as f:
        src = tmp / "align_step.cc"
        src.write_text(_emulated_source(f.read()))
    lib = tmp / "libalign_emulated.so"
    cmd = ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
           *defines, "-I", os.path.join(HERE, "cuda_emulator"), str(src), "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    handle = ctypes.CDLL(str(lib))
    argtypes, restype = kalign._SIGNATURES["evo_align_step"]
    handle.evo_align_step.argtypes = argtypes
    handle.evo_align_step.restype = restype
    return handle.evo_align_step


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel's library, compiled for the CPU."""
    return _compile(tmp_path_factory.mktemp("align_emulated"))


@pytest.fixture(scope="module")
def emulated_clock(tmp_path_factory):
    """Its clock build (-DEVO_ALIGN_CLOCKS), compiled for the CPU."""
    return _compile(tmp_path_factory.mktemp("align_emulated_clock"), "-DEVO_ALIGN_CLOCKS")


def _launch(fn, *args):
    assert fn(*args, None) == 0


def run_emulated(fn, table, grads, latest):
    """One emulated launch through the wrapper's arena and pointer array:
    (fields, ran, cost, lost, integrated, trips)."""
    ins = [getattr(table, n) for n in kalign._IN_NAMES]
    outs = kalign._run(fn, table, ins, grads, latest, ("integrated", "trips"), _launch)
    return ({n: outs[n] for n in kalign.OUT_FIELDS}, outs["ran"], outs["cost"], outs["lost"],
            outs["integrated"], outs["trips"])


def assert_matches_plain(fn, fields_np, grads, rows):
    table = tps.table_from_numpy(fields_np, device="cpu")
    got, ran, cost, lost, img, trips = run_emulated(fn, table, grads, grads[0])
    ref, ref_ran, ref_cost, ref_lost = talign.solve_step_ref(table, grads, grads[0])
    assert torch.equal(ran, ref_ran)
    sure = (ref.final_costs.median(1).values - tables.LOST_COST_THRESHOLD).abs() > 1e-5
    assert torch.equal(lost[sure], ref_lost[sure])
    tables.assert_same_step(tps.table_to_numpy(table.replace(**got)), tps.table_to_numpy(ref),
                            ran.numpy(), cost.numpy(), ref_cost.numpy(),
                            fields_np["center"], rows)
    assert torch.equal(img[ran], talign.integrate_events(table)[ran])
    assert (img[~ran] == 0).all()
    assert (trips[ran] >= 1).all() and (trips[~ran] == 0).all()
    assert (cost[~ran] == 0).all()
    return got, ran, cost, lost


def test_emulated_kernel_edge_rows_match_plain(emulated):
    """`torch_align_tables.edge_table`: ordinary ready rows beside one row
    of each edge case (no integration set, events outside the rect, a window
    clamped at the border, a rect out of the image, a border-lost row, a
    warp off the image, a degenerate system, a lost row, rows not ready,
    dead or uninitialised); then the row with a NaN flow alone, whose every
    step is bad: NaN where the plain version gives NaN."""
    rng = np.random.default_rng(5)
    grads = torch.as_tensor(tables.smooth_grads(rng))
    fields, rows = tables.edge_table(rng, grads.numpy(), nan_row=True)
    nan_row = rows.pop("nan_flow")
    finite = {k: v[:nan_row] for k, v in fields.items()}
    assert_matches_plain(emulated, finite, grads, rows)

    table = tps.table_from_numpy({k: v[nan_row:] for k, v in fields.items()}, device="cpu")
    got, ran, cost, lost, _, _ = run_emulated(emulated, table, grads, grads[0])
    want, ref_ran, ref_cost, ref_lost = talign.solve_step_ref(table, grads, grads[0])
    assert ran[0] and ref_ran[0] and not lost[0] and not ref_lost[0]
    assert torch.isnan(cost[0]) and torch.isnan(ref_cost[0])
    for name, v in got.items():
        a, b = v[0], getattr(want, name)[0]
        assert (torch.equal(torch.isnan(a), torch.isnan(b)) if a.is_floating_point()
                else torch.equal(a, b)), name


def test_emulated_kernel_ready_rows_match_plain_and_not_the_block(emulated):
    """Eight ready rows of the window scan's table (`multihost._ready_table`,
    the gradients of `_scan_inputs`) against the plain version; then rows
    0-3 launched alone: the same bits as in the 8-row launch."""
    t = multihost._ready_table(np.random.default_rng(1), 8, 180, 240)
    grads = torch.as_tensor(multihost._scan_inputs(np.random.default_rng(2), 2, 2048,
                                                   180, 240)[-1])
    got, ran, cost, lost = assert_matches_plain(
        emulated, t, grads, {f"row_{i}": i for i in range(8)})
    assert ran.all()
    half = tps.table_from_numpy({k: v[:4] for k, v in t.items()}, device="cpu")
    got4, ran4, cost4, lost4, _, _ = run_emulated(emulated, half, grads, grads[0])
    for name, v in got4.items():
        assert torch.equal(v, got[name][:4]), name
    for a, b in ((ran4, ran), (cost4, cost), (lost4, lost)):
        assert torch.equal(a, b[:4])


def test_emulated_clock_build_keeps_the_bits_and_adds_up(emulated, emulated_clock):
    """The clock build on eight rows of the window scan's table, the last
    one dead: the same bits as the plain build in every output, and each
    ready row's stage times (`kernels.align_step.STAGES`, the emulation's
    nanoseconds for the card's cycles) add up to its total, which is
    positive; the dead row's are 0."""
    t = multihost._ready_table(np.random.default_rng(1), 8, 180, 240)
    t["alive"][7] = False
    grads = torch.as_tensor(multihost._scan_inputs(np.random.default_rng(2), 2, 2048,
                                                   180, 240)[-1])
    table = tps.table_from_numpy(t, device="cpu")
    ins = [getattr(table, n) for n in kalign._IN_NAMES]
    plain = kalign._run(emulated, table, ins, grads, grads[0], ("integrated", "trips"),
                        _launch)
    clocked = kalign._run(emulated_clock, table, ins, grads, grads[0],
                          ("integrated", "trips", "clocks"), _launch)
    for name, v in plain.items():
        assert torch.equal(torch.nan_to_num(v), torch.nan_to_num(clocked[name])), name
    ran, clocks = plain["ran"], clocked["clocks"]
    assert ran[:7].all() and not ran[7]
    assert torch.equal(clocks[ran][:, :-1].sum(1), clocks[ran][:, -1])
    assert (clocks[ran] >= 0).all() and (clocks[ran][:, -1] > 0).all()
    assert (clocks[~ran] == 0).all()
