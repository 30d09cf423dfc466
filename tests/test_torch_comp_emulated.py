"""The compensation kernels' sources, `evo_tpu_torch/csrc/comp_tile.cu`
(kernel A: the tile residual and its Jacobian) and `comp_step.cu` (kernel
B: the window's LM step), run on the CPU: compiled by g++ against the
stand-in CUDA headers under `tests/cuda_emulator/` (a fiber for each CUDA
thread, the fibers of a cluster taking turns between barriers, barriers
for `__syncthreads` and `__syncwarp`, the launch's dynamic shared memory a
buffer of the block), called through the
wrappers' own argument packing, and held to the plain versions in
`tracker.compensate` on the same CPU tensors. The window is the one of
`tests/test_torch_compensate.py` (a 60x80 sensor, 12 tiles of 20 px, at
most 256 events a tile, band 8: kernel B's block-wide factorisation),
alone and beside a second window; kernel B also at the bands of the main
path's grids, which its register factorisation takes, on a 60x120 sensor
(18 tiles, band 12, as the 40 px tiles' 6 columns) and a 40x240 one (24
tiles, band 24, as the 20 px tiles' 12 columns), and the loop at band 12.

Bars: kernel A's r and its score (the loss, r = maxRes - score, which r
near 1000 holds to 6e-5 alone) within 1e-4 relative and J within 1e-3 of
the plain version (reverse mode there, forward mode here, the splat and the
loss summed in other orders), `escaped` equal, for both losses, on 20 px
tiles and on 40 px tiles (120x120 padded: the loss in strips); kernel B's
solve with a backward error of at most 1e-6 on the plain version's
assembled system (float32 rounding gives ~3e-8; its forward error against
the plain Cholesky grows with the system's condition: 1.1e-4 of the step at
condition 2.8e4, the first window here, where LAPACK's own is 7.6e-5 against
a float64 solve), `ok` equal, also where a NaN or a negative pivot makes a
window's factorisation fail (its step NaN); the whole loop
(`compensate.lm_motion_field_on_card`, its launches emulated) against the
plain loop: field within 1e-4 px/ms, cost within 1e-5 relative, the same
trips, and the same bits whether the host reads the stop flag every trip
or every fourth. A row's or a window's result must not depend on what is
launched beside it: alone, it gives the bits it gives in the batch.

The emulation checks the kernels' logic and arithmetic, not their speed:
g++ rounds each operation as `nvcc -fmad=false` does, but `expf` and
`sqrtf` are glibc's, not CUDA's."""

import ctypes
import os
import re
import subprocess
from functools import partial

import numpy as np
import pytest
import torch

from evo_tpu_torch.dist import temporal
from evo_tpu_torch.kernels import comp_step, comp_tile
from evo_tpu_torch.run.time_comp import backward_error
from evo_tpu_torch.tracker import compensate as tcomp

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(tcomp.__file__), "..", "csrc")
H, W = 60, 80
PARAMS = tcomp.CompensateParams(max_iters=25, events_per_tile_cap=256)
KW = dict(tile=20, scale=1e-3, tv_weight=1e3, tv_huber=10.0)


def _emulated_source(src: str) -> str:
    """The source with each launch made a call of the stand-in's
    `evo_emu::launch`, and its dynamic shared memory the block's buffer."""
    out, n = re.subn(r"(\w+)<<<(.*?)>>>\((.*?)\);",
                     r"evo_emu::launch(\2, [&] { \1(\3); });", src, flags=re.S)
    assert n >= 1, "no kernel launch found"
    out, m = re.subn(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                     r"float* \1 = evo_emu::dynamic_smem();", out)
    assert m >= 1, "no dynamic shared memory found"
    return out


def _compile(tmp, name: str, signatures: dict):
    with open(os.path.join(CSRC, name + ".cu")) as f:
        src = tmp / (name + ".cc")
        src.write_text(_emulated_source(f.read()))
    lib = tmp / f"lib{name}_emulated.so"
    cmd = ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
           "-I", os.path.join(HERE, "cuda_emulator"), str(src), "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    handle = ctypes.CDLL(str(lib))
    for fn, (argtypes, restype) in signatures.items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = restype
    return handle


@pytest.fixture(scope="module")
def tile_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("comp_tile"), "comp_tile", comp_tile._SIGNATURES)


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("comp_step"), "comp_step", comp_step._SIGNATURES)


def line_window(seed=7, vel=0.05, h=H, w=W):
    """Events on vertical lines drifting at `vel` px/ms over 100 ms, 4000 on
    the 60x80 sensor and as dense on an h x w one."""
    rng = np.random.default_rng(seed)
    n = 4000 * h * w // (H * W)
    t_us = np.sort(rng.uniform(0, 100_000, n)).astype(np.int64)
    base_x = rng.choice(np.arange(5, w - 5, 10), n)
    x = np.clip(base_x + vel * 1e3 * t_us * 1e-6 + rng.normal(0, 0.3, n), 0, w - 1)
    y = rng.uniform(0, h - 1, n)
    return x.astype(np.float64), y, t_us


@pytest.fixture(scope="module")
def windows():
    """Two windows' tile data, stacked and padded as `dist.temporal` does,
    with the grid's edges."""
    built = [tcomp.build_tile_data(*line_window(seed, vel), PARAMS, H, W, "cpu")
             for seed, vel in ((7, 0.05), (8, -0.03))]
    e_max = max(b[0].ex.shape[1] for b in built)
    data = temporal._stack([temporal._pad_tile_data(b[0], e_max) for b in built])
    return data, built[0][1]


def _events(data):
    return {f: getattr(data, f) for f in ("ex", "ey", "dt_us", "valid", "tlx", "tly",
                                          "active")}


def ok(fn):
    """The emulated entry `fn` as a wrapper's launch: it must return 0."""
    def launch(*args):
        assert fn(*args, None) == 0

    return launch


def run_tile(lib, vel, data, loss="edge", live=None, rows_per_window=1, tile=20,
             scores=None):
    """One emulated launch of kernel A: (r, J, escaped), and the score into
    `scores` when given; rows left unwritten keep NaN."""
    rows = vel.shape[0]
    r = torch.full((rows,), float("nan"))
    J = torch.full((rows, 2), float("nan"))
    esc = torch.zeros(rows, dtype=torch.bool)
    _, args = comp_tile.pack(vel, _events(data), tile=tile, scale=1e-3, loss=loss,
                             weight=tcomp.GAUSS_NORM, sigma=tcomp.SIGMA_SPLAT,
                             radius=tcomp.SPLAT_RADIUS, blur=tcomp.blur_taps(), r=r, J=J,
                             escaped=esc, score=scores, live=live,
                             rows_per_window=rows_per_window)
    assert lib.evo_comp_tile(*args, None) == 0
    return r, J, esc


def assert_kernel_a_matches_plain(lib, vel, data, loss, tile):
    """Kernel A against the plain version on these rows under the bars
    above; returns the escaped rows."""
    score = torch.full((vel.shape[0],), float("nan"))
    r, J, esc = run_tile(lib, vel, data, loss, tile=tile, scores=score)
    r_ref, J_ref = tcomp.tile_residual_and_jacobian_ref(vel, data, tile, 1e-3, loss)
    img = tcomp.warp_splat(vel, data.ex, data.ey, data.dt_us, data.valid, data.tlx,
                           data.tly, scale=1e-3, tile=tile, weight=tcomp.GAUSS_NORM)
    assert torch.equal(esc, img.mean((1, 2)) <= 1e-4)
    score_ref = (tcomp.tile_edge_loss(img) / tcomp.MAX_RES if loss == "edge"
                 else tcomp.tile_variance_loss(img))
    scored = data.active & ~esc
    np.testing.assert_allclose(r.numpy(), r_ref.numpy(), rtol=1e-4)
    np.testing.assert_allclose(score[scored].numpy(), score_ref[scored].numpy(), rtol=1e-4)
    assert (score[~scored] == 0).all()
    np.testing.assert_allclose(J.numpy(), J_ref.numpy(), atol=1e-3)
    assert np.abs(J_ref.numpy()).max() > 1.0  # the bars are well below the signal
    assert float(score_ref[scored].abs().min()) > 1e-3
    return r, J, esc


def flat(data):
    nw, T = data.ex.shape[:2]
    return data.map(lambda a: a.reshape((nw * T,) + a.shape[2:]).contiguous())


def tile_velocities(rows, seed=1):
    vel = torch.as_tensor(np.random.default_rng(seed).normal(0.05, 0.03, (rows, 2)),
                          dtype=torch.float32)
    vel[1] = torch.tensor([3e5, -2e5])  # its events leave the padded tile: escaped
    vel[2] = 0.0  # integer positions: outer taps exactly at |d| == radius
    if rows > 4:
        # its events spread over most of the padded tile: a reach too wide
        # for more than a few private copies, so a warp deposits one plane
        vel[4] = torch.tensor([0.4, -0.3])
    return vel


@pytest.mark.parametrize("loss", ["edge", "variance"])
@pytest.mark.parametrize("nw", [1, 2])
def test_kernel_a_matches_plain(tile_lib, windows, loss, nw):
    data = flat(windows[0].map(lambda a: a[:nw].clone()))
    data.active[3] = False  # an inactive tile: r = 0, J = 0
    rows = data.ex.shape[0]
    vel = tile_velocities(rows)
    r, J, esc = assert_kernel_a_matches_plain(tile_lib, vel, data, loss, 20)
    assert esc[1] and not esc[0] and r[3] == 0 and (J[3] == 0).all()


@pytest.mark.parametrize("loss", ["edge", "variance"])
def test_kernel_a_matches_plain_at_40_px_tiles(tile_lib, loss):
    """The window on 40 px tiles: two rows of 120x120 padded images, whose
    loss runs in strips of pool rows; row 0 alone gives its bits of the
    launch."""
    params = tcomp.CompensateParams(tile=40, max_iters=25, events_per_tile_cap=2048)
    data, edges, ty, tx, _, _ = tcomp.build_tile_data(*line_window(7, 0.05), params, H, W,
                                                      "cpu")
    assert (ty, tx) == (1, 2) and bool(data.active.all())
    vel = tile_velocities(4)[[0, 2]].contiguous()  # row 1: integer positions
    r, J, esc = assert_kernel_a_matches_plain(tile_lib, vel, data, loss, 40)
    assert not esc.any()
    # row 0 spread over most of its 120x120 tile: one copy, a plane a warp
    wide = torch.tensor([[0.9, -0.7], [0.0, 0.0]])
    assert_kernel_a_matches_plain(tile_lib, wide, data, loss, 40)
    r0, J0, _ = run_tile(tile_lib, vel[:1].contiguous(), data.map(lambda a: a[:1].contiguous()),
                         loss, tile=40)
    assert torch.equal(r0, r[:1]) and torch.equal(J0, J[:1])


def test_kernel_a_rows_do_not_depend_on_the_launch(tile_lib, windows):
    """Rows 0-4 alone give their bits of the 24-row launch, and so do they
    with 96 more padding events a row (a batch pads its rows to its longest
    window's); with `live`, the rows of a window that stopped are left
    unwritten."""
    data = flat(windows[0])
    vel = tile_velocities(24)
    r, J, _ = run_tile(tile_lib, vel, data)
    few = data.map(lambda a: a[:5].contiguous())
    r5, J5, _ = run_tile(tile_lib, vel[:5].contiguous(), few)
    assert torch.equal(r5, r[:5]) and torch.equal(J5, J[:5])
    padded = temporal._pad_tile_data(few, few.ex.shape[1] + 96)
    rp, Jp, _ = run_tile(tile_lib, vel[:5].contiguous(), padded)
    assert torch.equal(rp, r[:5]) and torch.equal(Jp, J[:5])
    live = torch.tensor([0, 1], dtype=torch.int32)
    r_l, J_l, _ = run_tile(tile_lib, vel, data, live=live, rows_per_window=12)
    assert torch.isnan(r_l[:12]).all() and torch.isnan(J_l[:12]).all()
    assert torch.equal(r_l[12:], r[12:]) and torch.equal(J_l[12:], J[12:])


def _system(windows, tile_lib, nan_window=None):
    """The normal-equation pieces of the loop's first trip at velocities
    near the solution (no escaped tile: its penalty's slope makes the system
    as ill-conditioned as float32 allows)."""
    data = flat(windows[0])
    edges = windows[1]
    vel = tile_velocities(24)
    vel[1] = vel[0]
    r, J, _ = run_tile(tile_lib, vel, data)
    r, J, v = r.reshape(2, 12), J.reshape(2, 12, 2), vel.reshape(2, 12, 2)
    if nan_window is not None:
        J[nan_window, 5, 0] = float("nan")
    d = v[:, edges.p] - v[:, edges.q]
    from evo_tpu_torch.solve.lm import huber_weights

    w2 = huber_weights(((1e3 * d.abs()) ** 2).sum(-1), 10.0) * 1e3 * 1e3
    jj = (J[..., :, None] * J[..., None, :]).contiguous()
    jr = (J * r[..., None]).contiguous()
    return jj, jr, w2.contiguous(), d.contiguous(), torch.tensor([1e-4, 3e-2]), edges


def grid_window(h, w, seed=7):
    """One line window's tile data on an h x w sensor of 20 px tiles, with
    the grid's edges."""
    data, edges, *_ = tcomp.build_tile_data(*line_window(seed, 0.05, h, w), PARAMS, h, w, "cpu")
    return data, edges


@pytest.mark.parametrize("h, w, band", [(60, 120, 12), (40, 240, 24), (40, 160, 16)])
def test_kernel_b_solve_at_the_grids_bands(step_lib, h, w, band):
    """The solve entry at the bands of the repo's grids (12 and 24 in warp
    0's registers; 16, as the 15 px grid's 32, over the block), on three
    windows of the plain residuals: a good one (backward error 1e-6), one
    with a NaN in a tile's Jacobian and one with a negative pivot (both: ok
    false, step NaN, as `cholesky_ex` says); the good window alone gives its
    bits."""
    data, edges = grid_window(h, w)
    assert edges.band == band
    t = edges.t
    vel = torch.as_tensor(np.random.default_rng(3).normal(0.05, 0.02, (t, 2)),
                          dtype=torch.float32)
    r, J = tcomp.tile_residual_and_jacobian_ref(vel, data, 20, 1e-3, "edge")
    from evo_tpu_torch.solve.lm import huber_weights

    v, r, J = vel.expand(3, t, 2), r.expand(3, t).clone(), J.expand(3, t, 2).clone()
    J[1, t // 2, 0] = float("nan")
    d = (v[:, edges.p] - v[:, edges.q]).contiguous()
    w2 = (huber_weights(((1e3 * d.abs()) ** 2).sum(-1), 10.0) * 1e3 * 1e3).contiguous()
    jj = (J[..., :, None] * J[..., None, :]).contiguous()
    jr = (J * r[..., None]).contiguous()
    jj[2, t // 3] = -1e12 * torch.eye(2)  # a negative pivot at row 2 (t // 3)
    lam = torch.tensor([1e-4, 1e-4, 1e-4])
    got, good = comp_step.run_solve(ok(step_lib.evo_comp_solve), jj, jr, w2, d, lam, edges)
    plain = tcomp.tile_system_ref(3, t, edges.p, edges.q)
    want, ok_ref = plain(jj, jr, w2, d, lam)
    assert good.tolist() == ok_ref.tolist() == [True, False, False]
    assert torch.isnan(got[1:]).all() and torch.isfinite(got[0]).all()
    A, b = plain.assemble(jj, jr, w2, d, lam)
    assert backward_error(A[:1], b[:1], got[:1]).item() <= 1e-6
    one, ok1 = comp_step.run_solve(ok(step_lib.evo_comp_solve), *(
        a[:1].contiguous() for a in (jj, jr, w2, d, lam)), edges)
    assert torch.equal(one, got[:1]) and bool(ok1[0])


@pytest.mark.parametrize("nan_window", [None, 0])
def test_kernel_b_solve_matches_plain(tile_lib, step_lib, windows, nan_window):
    jj, jr, w2, d, lam, edges = _system(windows, tile_lib, nan_window)
    assert edges.band == 8  # 4 tile columns
    got, good = comp_step.run_solve(ok(step_lib.evo_comp_solve), jj, jr, w2, d, lam, edges)
    plain = tcomp.tile_system_ref(2, 12, edges.p, edges.q)
    want, ok_ref = plain(jj, jr, w2, d, lam)
    assert torch.equal(good, ok_ref)
    assert good.tolist() == [nan_window is None, True]
    A, b = plain.assemble(jj, jr, w2, d, lam)
    eta = backward_error(A, b, got)
    for w in range(2):
        if good[w]:
            assert eta[w] <= 1e-6
        else:
            assert torch.isnan(got[w]).all()
    # a window alone gives its bits of the two-window launch
    one, ok1 = comp_step.run_solve(ok(step_lib.evo_comp_solve),
                                   jj[1:].contiguous(), jr[1:].contiguous(),
                                   w2[1:].contiguous(), d[1:].contiguous(),
                                   lam[1:].contiguous(), edges)
    assert torch.equal(one[0], got[1]) and bool(ok1[0])


class _EmulatedTileLaunch:
    """`kernels.comp_tile.TileLaunch` with the emulated library."""

    lib = None

    def __init__(self, vel, events, *, r, J, **kw):
        self._ptrs, self._args = comp_tile.pack(vel, events, r=r, J=J, **kw)
        self._keep = (vel, events, r, J)

    def launch(self):
        ok(self.lib.evo_comp_tile)(*self._args)


def emulated_loop(tile_lib, step_lib, data, edges, v0, monkeypatch, max_iters=25,
                  reads_every=4):
    """`compensate.lm_motion_field_on_card` on CPU tensors, its two kernels'
    launches emulated, reading the stop flag every `reads_every` trips: its
    final state (v, cost, cost0, iters) and the number of reads."""
    _EmulatedTileLaunch.lib = tile_lib
    monkeypatch.setattr(comp_tile, "TileLaunch", _EmulatedTileLaunch)
    monkeypatch.setattr(comp_step, "LmLoop", partial(
        comp_step.LmLoop, launch=ok(step_lib.evo_comp_lm_step)))
    monkeypatch.setattr(tcomp, "READS_EVERY", reads_every)
    tcomp.reset_counts()
    loop = tcomp.lm_motion_field_on_card(v0, flat(data), edges, **KW, max_iters=max_iters,
                                         loss="edge")
    return loop, tcomp.host_reads


def test_emulated_loop_matches_the_plain_loop_at_band_12(tile_lib, step_lib, monkeypatch):
    """The loop on a 60x120 sensor (band 12, the 40 px grid's) against the
    plain loop: field within 1e-4 px/ms, cost within 1e-5 relative, the
    same trips. The window is `line_window`'s (its density scaled to the
    sensor), whose stop is decided with margin (7 trips in both loops).
    A first window of 200 events a tile (seed 11) parts the loops at an
    accept test whose two costs tie in float32 (17,997,592, spacing 2): the
    plain loop stops at 11 trips, kernel B's at 22, with the block-wide
    factorisation as with the register one. That is float32 rounding
    deciding an LM test, not a fault of the kernels' logic; ROADMAP §C
    item 7 records it."""
    data, edges = grid_window(60, 120)
    data = data.map(lambda a: a[None])
    v0 = torch.zeros((1, edges.t, 2))
    got, _ = emulated_loop(tile_lib, step_lib, data, edges, v0, monkeypatch)
    want = tcomp.lm_motion_field(
        v0, flat(data), **KW, max_iters=25, loss="edge",
        edge_diffs=lambda v: v[:, edges.p] - v[:, edges.q], solve=tcomp.tile_system(1, edges))
    np.testing.assert_allclose(got.v.numpy(), want.v.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.cost.numpy(), want.cost.numpy(), rtol=1e-5)
    assert torch.equal(got.iters, want.iters) and (got.cost < got.cost0).all()


@pytest.mark.parametrize("nw", [1, 2])
def test_emulated_loop_matches_the_plain_loop(tile_lib, step_lib, windows, nw, monkeypatch):
    data = windows[0].map(lambda a: a[:nw])
    edges = windows[1]
    v0 = torch.zeros((nw, 12, 2))
    got, reads = emulated_loop(tile_lib, step_lib, data, edges, v0, monkeypatch)
    want = tcomp.lm_motion_field(
        v0, flat(data), **KW, max_iters=25, loss="edge",
        edge_diffs=lambda v: v[:, edges.p] - v[:, edges.q], solve=tcomp.tile_system(nw, edges))
    np.testing.assert_allclose(got.v.numpy(), want.v.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.cost.numpy(), want.cost.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got.cost0.numpy(), want.cost0.numpy(), rtol=1e-5)
    assert torch.equal(got.iters, want.iters)
    assert (got.cost < got.cost0).all() and (got.iters >= 2).all()
    if nw == 2:
        # the second window alone: the bits it has in the batch
        one, _ = emulated_loop(tile_lib, step_lib, data.map(lambda a: a[1:]), edges, v0[1:],
                               monkeypatch)
        assert torch.equal(one.v[0], got.v[1]) and one.cost[0] == got.cost[1] \
            and one.cost0[0] == got.cost0[1]
        return
    # a read every trip or every third: the bits of a read every fourth; the
    # trips queued past a stop leave the window as it is
    past = int(got.iters.max()) % 4 != 0
    for g in (1, 3):
        other, n = emulated_loop(tile_lib, step_lib, data, edges, v0, monkeypatch,
                                 reads_every=g)
        for name in ("v", "cost", "cost0", "iters"):
            assert torch.equal(getattr(other, name), getattr(got, name))
        assert n > reads
        past |= int(got.iters.max()) % g != 0
    assert past  # some of these runs queued trips past the stop
