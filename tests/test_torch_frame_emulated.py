"""The frame path's three kernel sources, `evo_tpu_torch/csrc/frame_maps.cu`
(gradient pair, Harris response, pyramid), `corner_select.cu` (the corner
selection) and `frame_rows.cu` (LK of the new rows, their flow
initialisation, the frame's re-budget), run on the CPU: compiled by g++
against the stand-in CUDA headers under `tests/cuda_emulator/` (as
`tests/test_torch_vo_emulated.py` does), called through the wrappers' own
argument packing (`kernels.frame_maps.run`, `kernels.corner_select.run`,
`kernels.frame_rows.run_rows`) and held to the plain versions
and to `evo_tpu`'s functions on the same numpy inputs:
`tests/test_torch_frame.py`'s texture pair and frames of the simulated
`3walls` scene.

Bars, each with its reason:
- `frame_maps`: every map within 1e-5 of the plain version and of `evo_tpu`
  (float32 convolutions summed in another order; the images lie in [0, 1]);
- `corner_select`: the plain version's corners, order and scores exactly on
  the same response (selection moves no value); against `evo_tpu`'s
  `detect_corners` on the image, the corner set and order equal and the
  scores within 1e-4 relative (`tests/test_torch_frame.py`'s bar). Also on
  a response with more candidates than one block's shared memory could
  list (the candidates are a bitmask there and a radix select cuts them to
  K), on one whose responses are equal, where the lower flat index ranks
  first, on chains of candidates that block each other inside one greedy
  step of 32 (also against `evo_tpu`'s fixpoint, exactly), and with more
  than 256 corners; the same selection from clusters of 2 and 3 blocks;
- `frame_rows`: LK's flow within 1e-3 px and the same status for rows near
  each image edge, on a flat patch, far motion through noise, and a smooth
  blob whose level-2 iterate travels past its slack, against the
  plain version and `evo_tpu`'s `pyramidal_lk`; the table fields it writes
  equal to the plain version's, budgets included, warps and flows within
  1e-3 px and 1e-5 rad (where LK's float32 stop test parts the two, the
  trips there are named and printed); a row's result the same bits when
  launched alone; at radius 15 (two samples a thread) against the plain
  version and `evo_tpu`'s `pyramidal_lk` under the same bars; the clock
  build the plain build's bits;
- the tracker refuses at construction, on the card, what the kernels do
  not take;
- the slice: the fused frame path (`EventTracker.process_frame_window` with
  the device policy) with all three kernels emulated against `evo_tpu`'s
  tracker over the first 6 frame windows, under the whole-slice bars of
  `tests/test_torch_tracker.py` (the same track ids, and the trajectory
  points within 0.05 px: the solves' float32 noise carries the centres
  apart by ~1e-3 px a frame, as it does the plain version's) and, after
  every window, the table's decisions of
  `tests/test_torch_pipeline.py::test_frame_window_from_carried_state_matches_jax`
  (alive, track ids, gradient slots, budgets equal).

The emulation checks the kernels' logic and arithmetic, not their speed:
g++ rounds each operation as `nvcc -fmad=false` does, but `logf`, `atan2f`
and `sincosf` are glibc's, not CUDA's.
"""

import ctypes
import os
import re
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu.kernels import gradients as jgrad
from evo_tpu.kernels import harris as jharris
from evo_tpu.kernels import lk as jlk
from evo_tpu.tracker import detector as jdet
from evo_tpu_torch.io import sim
from evo_tpu_torch.kernels import corner_select as kcs
from evo_tpu_torch.kernels import frame_maps as kfm
from evo_tpu_torch.kernels import frame_rows as kfr
from evo_tpu_torch.kernels import lk as tlk
from evo_tpu_torch.tracker import detector as tdet
from evo_tpu_torch.tracker import patch_state as tps
from tests.test_torch_frame import SHIFT, _texture

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(kfm.__file__), "..", "csrc")
CS_THREADS = 128  # the emulated selection's block (1024 on the card)
CS_CLUSTER = 2  # its cluster (8 on the card): more than one block, so the DSMEM paths run
CS_BUILD = (f"-DEVO_CS_THREADS={CS_THREADS}", f"-DEVO_CS_CLUSTER={CS_CLUSTER}")
KW = dict(max_corners=100, quality_level=0.01, min_distance=10.0, border=13)


def _emulated_source(src: str) -> str:
    """The source with its launch made a call of the stand-in's
    `evo_emu::launch` (a `<<<...>>>` launch) or `evo_emu::launch_ex` (a
    `cudaLaunchKernelEx`, with its cluster attribute) and its dynamic shared
    memory the block's buffer."""
    out, n = re.subn(r"(\w+)<<<(.*?)>>>\((.*?)\);",
                     r"evo_emu::launch(\2, [&] { \1(\3); });", src, flags=re.S)
    out, n_ex = re.subn(r"cudaLaunchKernelEx\(&(\w+), (\w+), (.*?)\);",
                        r"evo_emu::launch_ex(&\1, [&] { \2(\3); });", out, flags=re.S)
    assert n + n_ex == 1, "one kernel launch expected"
    return re.sub(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                  r"float* \1 = reinterpret_cast<float*>(evo_emu::dynamic_smem());", out)


def _compile(tmp, name: str, signatures: dict, *defines):
    with open(os.path.join(CSRC, name + ".cu")) as f:
        src = tmp / (name + ".cc")
        src.write_text(_emulated_source(f.read()))
    lib = tmp / f"lib{name}_emulated.so"
    cmd = ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
           *defines, "-I", os.path.join(HERE, "cuda_emulator"), "-I", CSRC, str(src),
           "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    handle = ctypes.CDLL(str(lib))
    for fn, (argtypes, restype) in signatures.items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = restype
    return handle


def ok(fn, *args):
    """A wrapper's launch of the emulated entry: it must return 0."""
    assert fn(*args, None) == 0


@pytest.fixture(scope="module")
def fm_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("frame_maps"), "frame_maps", kfm._SIGNATURES)


@pytest.fixture(scope="module")
def cs_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("corner_select"), "corner_select",
                    kcs._SIGNATURES, *CS_BUILD)


@pytest.fixture(scope="module")
def fr_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("frame_rows"), "frame_rows", kfr._SIGNATURES)


def maps_of(lib, img):
    return kfm.run(lib.evo_frame_maps, img, ok)


def select(lib, resp, **kw):
    return kcs.run(lib.evo_corner_select, resp, ok, **{**KW, **kw})


@pytest.fixture(scope="module")
def textures():
    return _texture(), _texture(*SHIFT)


@pytest.fixture(scope="module")
def walls():
    """Frames 1 and 2 of the simulated `3walls` scene (the smoke's, cut to
    0.15 s) as float32 [0, 1] images."""
    ds = sim.to_dataset(sim.EventCameraSimulator(
        sim.SimParams(duration_s=0.15, fps=20.0, seed=3, scene="3walls",
                      contrast_threshold=0.05), device="cpu").generate())
    tr = tdet.EventTracker(device="cpu")
    return [tr._as_f32_image(ds.image_u8(k)).numpy() for k in (1, 2)]


def _images(textures, walls):
    return [("texture", textures[0]), ("texture_shifted", textures[1]),
            ("walls_1", walls[0]), ("walls_2", walls[1])]


# ---- frame_maps -------------------------------------------------------------

def test_frame_maps_matches_plain_and_jax(fm_lib, textures, walls):
    for name, img in _images(textures, walls):
        t = torch.from_numpy(img)
        got = maps_of(fm_lib, t)
        ref = kfm.frame_maps_ref(t)
        jax_maps = (np.asarray(jdet._compute_grads(jnp.asarray(img))),
                    np.asarray(jharris.harris_response(jnp.asarray(img))),
                    *[np.asarray(a) for a in jgrad.image_pyramid(jnp.asarray(img), 3)[1:]])
        for k, (a, b, c) in enumerate(zip(got, ref, jax_maps)):
            assert a.shape == b.shape == c.shape, (name, k)
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=f"{name} {k}")
            np.testing.assert_allclose(a.numpy(), c, atol=1e-5, err_msg=f"{name} {k}")


def test_frame_maps_odd_sizes_match_plain(fm_lib):
    """A frame whose sides are not multiples of the tile (97 x 131): the
    last tiles' edges and the pyramid's ceil(n / 2) levels."""
    img = torch.from_numpy(np.random.default_rng(4).random((97, 131), dtype=np.float32))
    for a, b in zip(maps_of(fm_lib, img), kfm.frame_maps_ref(img)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


# ---- corner_select ----------------------------------------------------------

def _assert_same_selection(got, ref):
    same = kcs.same_corners(got, ref)
    assert same["equal"], same
    return same


def test_corner_select_matches_plain_and_jax(fm_lib, cs_lib, textures, walls):
    for name, img in _images(textures, walls):
        resp = maps_of(fm_lib, torch.from_numpy(img))[1]
        got = select(cs_lib, resp)
        same = _assert_same_selection(got, kcs.corner_select_ref(resp, **KW))
        assert same["accepted"] >= 8, name
        xy_j, score_j, ok_j = (np.asarray(a) for a in
                               jharris.detect_corners(jnp.asarray(img), **KW))
        np.testing.assert_array_equal(got[2].numpy(), ok_j, err_msg=name)
        np.testing.assert_array_equal(got[0].numpy(), xy_j, err_msg=name)
        np.testing.assert_allclose(got[1].numpy(), score_j, rtol=1e-4, atol=1e-7)


def test_corner_select_holds_more_candidates_than_shared_memory(cs_lib):
    """A noise response of 1080 x 1440: its candidates (peaks above the
    threshold) outnumber what 227 KB could list as 8-byte keys; the kernel
    keeps them as bits and cuts them to K by its radix select. The same
    corners as the plain version, at 400 and at 40 candidates (K)."""
    from evo_tpu_torch.kernels import harris

    img = torch.from_numpy(np.random.default_rng(7).random((1080, 1440), dtype=np.float32))
    resp = harris.harris_response(img)
    n = kcs.candidates(resp, **KW)
    assert n > 232448 // 8, n
    for m in (100, 10):
        kw = dict(KW, max_corners=m)
        got = select(cs_lib, resp, **kw)
        same = _assert_same_selection(got, kcs.corner_select_ref(resp, **kw))
        assert same["accepted"] == m


def test_corner_select_ties_rank_the_lower_index_first(cs_lib):
    """A response of equal isolated peaks every 5 px (1,728 of them, 48 x
    36), some raised: the radix select's threshold falls among equal keys,
    and the lower flat index ranks first, as `lax.top_k` and the plain
    version's stable sort have it; the greedy pass then keeps every other
    peak. Also with fewer candidates than K (no cut)."""
    h, w = 180, 240
    resp = torch.zeros(h, w)
    resp[2::5, 2::5] = 1.0
    resp[40:60:5, 100:200:5] = 2.0  # ranks first, then the 1.0s in flat order
    for kw in (dict(KW, border=0), dict(KW, border=0, max_corners=50),
               dict(KW, border=60, max_corners=100)):
        got = select(cs_lib, resp, **kw)
        same = _assert_same_selection(got, kcs.corner_select_ref(resp, **kw))
        assert same["accepted"] > 10
    # the lowest flat indices among equals first
    got = select(cs_lib, resp, border=0, max_corners=30)
    xy = got[0][got[2]].numpy()
    flat = xy[:, 1] * w + xy[:, 0]
    assert (np.diff(flat[got[1][got[2]].numpy() == 1.0]) > 0).all()


def _edge_response(name):
    g = torch.Generator().manual_seed(5)
    if name == "zeros":
        return torch.zeros(180, 240)
    if name == "negative":
        return -torch.rand(180, 240, generator=g)
    if name == "nan":
        r = torch.rand(180, 240, generator=g)
        r[90, 120] = float("nan")  # the largest response is NaN: no candidate
        return r
    if name == "one_peak":
        r = torch.zeros(180, 240)
        r[50, 60] = 1.0
        return r
    return torch.rand(20, 30, generator=g)  # smaller than a word row, border 2


@pytest.mark.parametrize("name", ["zeros", "negative", "nan", "one_peak", "small"])
def test_corner_select_edge_responses_match_plain(cs_lib, name):
    """Responses without candidates (zero, negative, a NaN inside the
    border), with one, and a 20 x 30 one: the plain version's corners."""
    kw = dict(KW, border=2) if name == "small" else KW
    resp = _edge_response(name)
    same = _assert_same_selection(select(cs_lib, resp, **kw), kcs.corner_select_ref(resp, **kw))
    if name == "small":
        assert same["accepted"] >= 1, same
    else:
        assert same["accepted"] == (name == "one_peak"), same


def test_corner_select_does_not_depend_on_the_block(cs_lib, tmp_path, textures):
    """The same selection from a cluster of 2 blocks of 128 threads and
    from one of 3 blocks of 64 (the bitmask's slices fall elsewhere)."""
    other = _compile(tmp_path, "corner_select", kcs._SIGNATURES, "-DEVO_CS_THREADS=64",
                     "-DEVO_CS_CLUSTER=3")
    from evo_tpu_torch.kernels import harris

    resp = harris.harris_response(torch.from_numpy(textures[0]))
    for a, b in zip(select(cs_lib, resp), select(other, resp)):
        assert torch.equal(a, b)


def _chain_response():
    """A 180 x 240 response of isolated peaks whose ranks run in chains, so
    that candidates within min_distance (10 px) of each other fall inside
    one greedy step of 32: along x, 8 px apart, A blocks B and B (not
    accepted) does not block C; a chain of four (A, C accepted, B, D not);
    one at (6, 8) px from its head, d^2 = 100 = min_distance^2 exactly, which
    does not block; and weaker peaks beside the strongest ones, blocked from
    a later step by the accepted list."""
    resp = torch.zeros(180, 240)
    score = 1000.0
    offsets = ([(0, 0), (8, 0), (16, 0)], [(0, 0), (8, 0), (16, 0), (24, 0)],
               [(0, 0), (6, 8)], [(0, 0), (9, 0), (9, 9)])
    k = 0
    for y in range(20, 160, 25):
        for x in range(20, 200, 40):
            for dx, dy in offsets[k % len(offsets)]:
                resp[y + dy, x + dx] = score
                score -= 1.0
            k += 1
    for y in range(20, 160, 25):  # the last step's: 4 px below each chain's head
        for x in range(20, 200, 40):
            resp[y + 4, x + 3] = score
            score -= 1.0
    return resp


@pytest.mark.parametrize("max_corners", [100, 30])
def test_corner_select_resolves_conflicts_inside_a_step(monkeypatch, cs_lib, max_corners):
    """Chains of candidates that block each other inside one step of 32
    (`_chain_response`), and with max_corners 30 the last corner accepted
    in the middle of a step: exactly the plain version's corners, order and
    scores, and `evo_tpu`'s `detect_corners` (its `[K, K]` fixpoint) on the
    same response, selection moving no value (exact)."""
    resp = _chain_response()
    kw = dict(KW, max_corners=max_corners)
    assert kcs.candidates(resp, **kw) > 64
    got = select(cs_lib, resp, **kw)
    same = _assert_same_selection(got, kcs.corner_select_ref(resp, **kw))
    assert same["accepted"] == (max_corners if max_corners < 50 else 60), same
    # evo_tpu's selection over the same response: its Harris step replaced,
    # run unjitted so no trace of the image's response is reused
    monkeypatch.setattr(jharris, "harris_response", lambda img, *a: jnp.asarray(resp.numpy()))
    xy_j, score_j, ok_j = (np.asarray(a) for a in jharris.detect_corners.__wrapped__(
        jnp.zeros((180, 240), jnp.float32), **kw))
    np.testing.assert_array_equal(got[2].numpy(), ok_j)
    np.testing.assert_array_equal(got[0].numpy(), xy_j)
    np.testing.assert_array_equal(got[1].numpy(), score_j)


def test_corner_select_takes_more_than_256_corners(cs_lib):
    """max_corners 300, above the limit of the kernel's former registers,
    on the Harris response of a 240 x 320 noise frame with a 4 px
    min_distance, which holds more candidates than K = 1,200: the plain
    version's corners, order and scores, all 300 accepted."""
    from evo_tpu_torch.kernels import harris

    img = torch.from_numpy(np.random.default_rng(12).random((240, 320), dtype=np.float32))
    resp = harris.harris_response(img)
    kw = dict(KW, max_corners=300, min_distance=4.0)
    assert kcs.candidates(resp, **kw) > 4 * 300
    same = _assert_same_selection(select(cs_lib, resp, **kw), kcs.corner_select_ref(resp, **kw))
    assert same["accepted"] == 300, same


def test_corner_select_clock_build_keeps_the_corners(tmp_path, cs_lib, textures):
    """The clock build (-DEVO_CS_CLOCKS): the plain build's corners, and its
    stages (the emulation's nanoseconds for the card's cycles) add up to its
    total."""
    clock = _compile(tmp_path, "corner_select", kcs._SIGNATURES, *CS_BUILD, "-DEVO_CS_CLOCKS")
    from evo_tpu_torch.kernels import harris

    resp = harris.harris_response(torch.from_numpy(textures[0]))
    clk = torch.zeros(len(kcs.STAGES), dtype=torch.int64)
    got = kcs.run(clock.evo_corner_select, resp, ok, **KW, clocks=clk)
    for a, b in zip(got, select(cs_lib, resp)):
        assert torch.equal(a, b)
    assert int(clk[:-1].sum()) == int(clk[-1]) > 0 and (clk >= 0).all()


# ---- frame_rows -------------------------------------------------------------

def _pyramids(a, b):
    """Both frames' pyramids, level 0 first (the plain version's, each level
    made contiguous, as the kernel writes them)."""
    return [tuple(x.contiguous() for x in kfm.pyramid(t, kfm.frame_maps_ref(t), 3))
            for t in (torch.from_numpy(a), torch.from_numpy(b))]


# the rows to track: (x, y), by what they test
EDGE_ROWS = {
    "left": (14.0, 90.0), "right": (225.5, 88.25), "top": (120.0, 14.0),
    "bottom": (119.5, 160.5), "top_left": (14.5, 14.5), "bottom_right": (225.0, 165.0),
    "half_up": (60.5, 60.5), "near_border_lost": (4.5, 100.0),
}


def _lk_table(points, rng, n_other: int = 6):
    """A table whose first rows are new (alive, not initialized) at
    `points`, then rows alive and initialized (budget only) and dead rows."""
    n = len(points) + 2 * n_other
    fields = tps.table_to_numpy(tps.empty_table(n, device="cpu"))
    fields["center"][: len(points)] = np.asarray(points, np.float32)
    fields["alive"][: len(points) + n_other] = True
    other = slice(len(points), len(points) + n_other)
    fields["initialized"][other] = True
    fields["center"][other] = rng.uniform(20, 160, (n_other, 2)).astype(np.float32) * [1.3, 1]
    th = rng.uniform(-0.1, 0.1, n_other)
    fields["warp"][other] = np.stack([np.cos(th), np.sin(th), rng.uniform(-2, 2, n_other),
                                      rng.uniform(-2, 2, n_other)], -1).astype(np.float32)
    fields["flow"][other] = rng.uniform(-3, 3, n_other).astype(np.float32)
    fields["num_of_events"][:] = 75
    return tps.table_from_numpy(fields, device="cpu")


def _run_rows(lib, table, pyr0, pyr1, grad, with_lk=True):
    return kfr.run_rows(lib.evo_frame_rows, ok, table, pyr0, pyr1, grad, with_lk=with_lk,
                        radius=10, num_iters=30, diagnostics=True)


def _assert_rows_match(got, ref, what):
    """The kernel's table and LK against the plain version's: LK status
    equal and flow within 1e-3 px; the fields equal, warps and flow angles
    within 1e-3 px and 1e-5 rad where LK's float32 sums part them."""
    (gt, gd), (rt, rd) = got, ref
    np.testing.assert_array_equal(gd["lk_status"].numpy(), rd["lk_status"].numpy(), what)
    tracked = rd["lk_status"].numpy()
    np.testing.assert_allclose(gd["lk_flow"].numpy()[tracked], rd["lk_flow"].numpy()[tracked],
                               atol=1e-3, err_msg=what)
    for name in ("alive", "initialized", "num_of_events"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(), getattr(rt, name).numpy(),
                                      err_msg=f"{what}: {name}")
    np.testing.assert_allclose(gt.warp.numpy(), rt.warp.numpy(), atol=1e-3, err_msg=what)
    np.testing.assert_allclose(gt.flow.numpy(), rt.flow.numpy(), atol=1e-5, err_msg=what)
    np.testing.assert_allclose(gt.time_without_update.numpy(),
                               rt.time_without_update.numpy(), rtol=1e-3, err_msg=what)


def test_frame_rows_match_plain_at_the_edges(fr_lib, textures):
    """New rows near each edge (their windows clamp at every level; level
    2 is 45 px high), one within the 5 px lost border, beside rows that only
    take their budget, on the texture pair: the plain version's fields and
    LK, and `evo_tpu`'s `pyramidal_lk` on the same points."""
    rng = np.random.default_rng(3)
    pyr0, pyr1 = _pyramids(*textures)
    grad = kfm.frame_maps_ref(torch.from_numpy(textures[1]))[0]
    table = _lk_table(list(EDGE_ROWS.values()), rng)
    got = _run_rows(fr_lib, table, pyr0, pyr1, grad)
    ref = tdet.frame_rows_ref(table, pyr0, pyr1, grad, with_lk=True, diagnostics=True)
    _assert_rows_match(got, ref, "texture edges")
    st = got[1]["lk_status"].numpy()
    assert st[:6].sum() >= 3 and not st[len(EDGE_ROWS):].any()
    # the lost-border row tracked but was lost; budgets moved off 75
    assert not got[0].alive[7] and (got[0].num_of_events[8:14] != 75).all()
    pts = np.asarray(list(EDGE_ROWS.values()), np.float32)
    valid = np.ones(len(pts), bool)
    _, flow_j, st_j = jlk.pyramidal_lk(jnp.asarray(textures[0]), jnp.asarray(textures[1]),
                                      jnp.asarray(pts), jnp.asarray(valid))
    st_j = np.asarray(st_j)
    np.testing.assert_array_equal(st[:len(pts)], st_j)
    np.testing.assert_allclose(got[1]["lk_flow"].numpy()[:len(pts)][st_j],
                               np.asarray(flow_j)[st_j], atol=1e-3)


def test_frame_rows_at_radius_15_match_plain_and_jax(fr_lib, textures):
    """LK at radius 15: (2 r + 1)^2 = 961 samples, more than the block's 640
    threads, so each thread takes two; new rows near the edges and inside
    the texture pair beside a row that only takes its budget: the plain
    version's fields and LK at radius 15 and `evo_tpu`'s `pyramidal_lk`
    there, under the module's LK bars (status equal, flow within 1e-3 px)."""
    rng = np.random.default_rng(6)
    pyr0, pyr1 = _pyramids(*textures)
    grad = kfm.frame_maps_ref(torch.from_numpy(textures[1]))[0]
    points = [EDGE_ROWS["left"], EDGE_ROWS["bottom_right"], EDGE_ROWS["half_up"], (120.0, 90.0)]
    table = _lk_table(points, rng, n_other=1)
    got = kfr.run_rows(fr_lib.evo_frame_rows, ok, table, pyr0, pyr1, grad, with_lk=True,
                       radius=15, num_iters=30, diagnostics=True)
    ref = tdet.frame_rows_ref(table, pyr0, pyr1, grad, with_lk=True, radius=15,
                              diagnostics=True)
    _assert_rows_match(got, ref, "radius 15")
    st = got[1]["lk_status"].numpy()
    assert st[:len(points)].sum() >= 2
    pts = np.asarray(points, np.float32)
    _, flow_j, st_j = jlk.pyramidal_lk(jnp.asarray(textures[0]), jnp.asarray(textures[1]),
                                      jnp.asarray(pts), jnp.ones(len(pts), bool), radius=15)
    st_j = np.asarray(st_j)
    np.testing.assert_array_equal(st[:len(pts)], st_j)
    np.testing.assert_allclose(got[1]["lk_flow"].numpy()[:len(pts)][st_j],
                               np.asarray(flow_j)[st_j], atol=1e-3)


def test_frame_rows_flat_patch_and_far_motion(fr_lib):
    """A frame pair with a flat region (det <= 1e-7: lost at the coarsest
    level), a noise region moved by 2 px (tracked) and one moved by 56 px,
    which LK cannot follow through noise (it stops at a false match inside
    its slack, or after 30 trips): the plain version's status, flow and
    fields, trips and all."""
    rng = np.random.default_rng(9)
    tex = rng.random((180, 240)).astype(np.float32)
    base = np.full((180, 240), 0.5, np.float32)
    base[:, 120:] = tex[:, 120:]
    img1 = np.full((180, 240), 0.5, np.float32)
    img1[:, 120:] = np.roll(tex, (2, 1), axis=(0, 1))[:, 120:]
    img1[100:, 120:] = np.roll(tex, (0, 56), axis=(0, 1))[100:, 120:]
    pyr0, pyr1 = _pyramids(base, img1)
    grad = kfm.frame_maps_ref(torch.from_numpy(img1))[0]
    points = [(40.0, 60.0), (60.0, 130.0), (170.0, 40.0), (160.0, 140.0), (180.5, 150.5)]
    table = _lk_table(points, rng, n_other=2)
    got = _run_rows(fr_lib, table, pyr0, pyr1, grad)
    ref = tdet.frame_rows_ref(table, pyr0, pyr1, grad, with_lk=True, diagnostics=True)
    _assert_rows_match(got, ref, "flat and travel")
    st = got[1]["lk_status"].numpy()
    assert not st[0] and not st[1] and st[2]
    trips = got[1]["lk_trips"].numpy()
    assert (trips[:5] >= 1).all() and (trips[:5] <= 30).all()
    print("trips by level (0, 1, 2):", trips[:5].tolist(),
          "last |dv|^2:", got[1]["lk_d2"].numpy()[:5].tolist())


@pytest.mark.parametrize("shift, tracked", [(40, True), (50, False)])
def test_frame_rows_travel_past_the_slack(fr_lib, shift, tracked):
    """A smooth blob (sigma 18 px) moved by `shift` px: at level 2 (45 px
    window, slack 22 - 10 - 1 = 11 px) LK's iterate travels shift / 4 px
    from its guess, 10 at 40 px (tracked) and 12.5 at 50 px, past the slack,
    where the travel guard fails the row though later levels converge: the
    plain version's status and fields."""
    yy, xx = np.mgrid[0:180, 0:240].astype(np.float64)

    def blob(cx):
        return (0.1 + np.exp(-((xx - cx) ** 2 + (yy - 90.0) ** 2) / (2 * 18.0 ** 2))
                ).astype(np.float32)

    pyr0, pyr1 = _pyramids(blob(100.0), blob(100.0 + shift))
    grad = kfm.frame_maps_ref(pyr1[0])[0]
    table = _lk_table([(100.0, 90.0), (85.0, 80.0), (110.0, 100.0)],
                      np.random.default_rng(4), n_other=1)
    got = _run_rows(fr_lib, table, pyr0, pyr1, grad)
    ref = tdet.frame_rows_ref(table, pyr0, pyr1, grad, with_lk=True, diagnostics=True)
    _assert_rows_match(got, ref, f"blob moved {shift} px")
    assert got[1]["lk_status"][:3].tolist() == [tracked] * 3
    assert got[0].initialized[:3].tolist() == [tracked] * 3


def test_frame_rows_budget_alone_and_no_lk(fr_lib, textures):
    """Without LK (the frame before the second, or `align.update_num_of_events`
    on the card): the budget of every live row, new rows untouched."""
    rng = np.random.default_rng(5)
    grad = kfm.frame_maps_ref(torch.from_numpy(textures[0]))[0]
    table = _lk_table(list(EDGE_ROWS.values()), rng)
    got = kfr.run_rows(fr_lib.evo_frame_rows, ok, table, (), (), grad, with_lk=False,
                       radius=10, num_iters=30, diagnostics=False)
    from evo_tpu_torch.tracker import align

    ref = align.update_num_of_events_ref(table, grad)
    for name in kfr.OUT_FIELDS:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_frame_rows_do_not_depend_on_the_other_rows(fr_lib, textures):
    """Rows 0-3 launched alone: the bits they get in the full launch."""
    rng = np.random.default_rng(3)
    pyr0, pyr1 = _pyramids(*textures)
    grad = kfm.frame_maps_ref(torch.from_numpy(textures[1]))[0]
    table = _lk_table(list(EDGE_ROWS.values()), rng)
    full, fdiag = _run_rows(fr_lib, table, pyr0, pyr1, grad)
    part = tps.PatchTable(**{k: getattr(table, k)[:4].contiguous() for k in tps.FIELDS})
    alone, adiag = _run_rows(fr_lib, part, pyr0, pyr1, grad)
    for name in kfr.OUT_FIELDS:
        assert torch.equal(getattr(alone, name), getattr(full, name)[:4]), name
    for name, v in adiag.items():
        assert torch.equal(v, fdiag[name][:4]), name


def test_frame_rows_clock_build_keeps_the_outputs(tmp_path, fr_lib, textures):
    """The clock build (-DEVO_FR_CLOCKS): the plain build's fields and LK
    diagnostics bit for bit, and each row's stages (the emulation's
    nanoseconds for the card's cycles) add up to its total."""
    clock = _compile(tmp_path, "frame_rows", kfr._SIGNATURES, "-DEVO_FR_CLOCKS")
    rng = np.random.default_rng(3)
    pyr0, pyr1 = _pyramids(*textures)
    grad = kfm.frame_maps_ref(torch.from_numpy(textures[1]))[0]
    table = _lk_table(list(EDGE_ROWS.values())[:4], rng, n_other=2)
    clk = torch.zeros((table.capacity, len(kfr.STAGES)), dtype=torch.int64)
    got = kfr.run_rows(clock.evo_frame_rows, ok, table, pyr0, pyr1, grad, with_lk=True,
                       radius=10, num_iters=30, diagnostics=True, clocks=clk)
    ref = _run_rows(fr_lib, table, pyr0, pyr1, grad)
    for name in kfr.OUT_FIELDS:
        assert torch.equal(getattr(got[0], name), getattr(ref[0], name)), name
    for name in kfr.DIAGNOSTICS:
        assert torch.equal(got[1][name], ref[1][name]), name
    assert (clk[:, :-1].sum(1) == clk[:, -1]).all() and (clk[:, -1] > 0).all()
    assert (clk >= 0).all() and (clk[:4, kfr.STAGES.index("sampling")] > 0).all()


def test_track_matches_plain_and_jax(fr_lib, textures):
    """LK alone (`kernels.lk.pyramidal_lk` on the card: the points as a
    table's new rows, `kernels.frame_rows.points_table`): the texture pair's
    corners, as `tests/test_torch_frame.py` tracks them."""
    img0, img1 = textures
    xy, _, okc = (t.numpy() for t in kcs.corner_select_ref(
        kfm.frame_maps_ref(torch.from_numpy(img0))[1], **dict(KW, max_corners=24)))
    pts = xy.copy()
    pts[~okc] = [3.0, 3.0]
    valid = okc.copy()
    valid[-1] = False
    pyr0, pyr1 = _pyramids(img0, img1)
    table, grad = kfr.points_table(torch.from_numpy(pts), torch.from_numpy(valid),
                                   pyr0[0].shape)
    _, diag = kfr.run_rows(fr_lib.evo_frame_rows, ok, table, pyr0, pyr1, grad, with_lk=True,
                           radius=10, num_iters=30, diagnostics=True)
    flow, st = diag["lk_flow"], diag["lk_status"]
    _, flow_r, st_r = tlk.track_pyramids_ref(pyr0, pyr1, torch.from_numpy(pts),
                                             torch.from_numpy(valid))
    _, flow_j, st_j = jlk.pyramidal_lk(jnp.asarray(img0), jnp.asarray(img1),
                                      jnp.asarray(pts), jnp.asarray(valid))
    st_j = np.asarray(st_j)
    np.testing.assert_array_equal(st.numpy(), st_r.numpy())
    np.testing.assert_array_equal(st.numpy(), st_j)
    assert st_j.sum() >= 6
    np.testing.assert_allclose(flow.numpy()[st_j], flow_r.numpy()[st_j], atol=1e-3)
    np.testing.assert_allclose(flow.numpy()[st_j], np.asarray(flow_j)[st_j], atol=1e-3)
    assert (flow.numpy()[~valid] == 0).all()


# ---- the slice ---------------------------------------------------------------

def _emulate_frame_kernels(monkeypatch, fm_lib, cs_lib, fr_lib):
    """The port's frame path on the CPU through the three emulated kernels."""
    def maps(img, block_size=3):
        assert block_size == 3
        return maps_of(fm_lib, img)

    monkeypatch.setattr(kfm, "frame_maps", maps)
    monkeypatch.setattr(kcs, "corner_select",
                        lambda resp, **kw: kcs.run(cs_lib.evo_corner_select, resp, ok, **kw))

    def rows(table, prev_pyr, cur_pyr, grad, *, with_lk, radius, num_iters=30,
             diagnostics=False):
        return kfr.run_rows(fr_lib.evo_frame_rows, ok, table, prev_pyr, cur_pyr, grad,
                            with_lk=with_lk, radius=radius, num_iters=num_iters,
                            diagnostics=diagnostics)

    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return rows(*args, **kw)

    monkeypatch.setattr(tdet, "frame_rows", counted)
    return calls


def test_fused_frame_path_emulated_matches_jax(monkeypatch, tmp_path, fm_lib, cs_lib, fr_lib):
    """Six fused frame windows (the device policy) of the simulated scene
    through both trackers, the port's with its frame path on the three
    emulated kernels (one `frame_rows` launch a window): after each window
    alive, track ids, gradient slots and budgets equal and the live centres
    within 0.05 px; at the end the final-cost log's (track, time) pairs, the
    trajectories' track ids, and every trajectory point the two share
    within 0.05 px."""
    from evo_tpu.io.davis import Davis240cDataset as JDataset
    from evo_tpu.io.replay import FrameWindowIterator as JWindows
    from test_torch_cli import _simulated

    calls = _emulate_frame_kernels(monkeypatch, fm_lib, cs_lib, fr_lib)
    (tmp_path / "ds").mkdir()
    ds = JDataset(_simulated(tmp_path / "ds", 0.3))
    wins = list(JWindows(ds))[:6]
    assert len(wins) == 6
    cap = 32
    jtr = jdet.EventTracker(jdet.TrackerParams(capacity=cap))
    ttr = tdet.EventTracker(tdet.TrackerParams(capacity=cap), device="cpu")
    assert ttr.params.device_policy

    def step(tr, w):
        ev = w.events
        t, h = tr.process_frame_window(
            ev.t_us, ev.x.astype(np.float64), ev.y.astype(np.float64),
            ev.p.astype(np.float64), w.image_t_us, w.image)
        return tr.consume_frame(t, h)

    live_seen = 0
    for k, w in enumerate(wins):
        jm, tm = step(jtr, w), step(ttr, w)
        for name in ("alive", "track_id", "grad_slot", "num_of_events"):
            np.testing.assert_array_equal(tm[name], jm[name], err_msg=f"frame {k}: {name}")
        live = jm["alive"]
        live_seen = max(live_seen, int(live.sum()))
        np.testing.assert_allclose(tm["center"][live], jm["center"][live], atol=0.05,
                                   err_msg=f"frame {k}")
    assert len(calls) == 6 and live_seen >= 10
    assert [(tid, t) for tid, _, t in ttr.final_cost_log] == \
        [(tid, t) for tid, _, t in jtr.final_cost_log]
    assert len(ttr.final_cost_log) >= 100
    assert set(ttr.trajectories) == set(jtr.trajectories)
    for tid, entries in jtr.trajectories.items():
        a, b = np.asarray(entries), np.asarray(ttr.trajectories[tid])
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(b[:, 1:], a[:, 1:], atol=0.05)


# ---- the wrappers --------------------------------------------------------------

@pytest.mark.parametrize("bad", [dict(block_size=5), dict(lk_levels=4),
                                 dict(max_patches=kcs.MAX_CORNERS + 1),
                                 dict(lk_radius=kfr.MAX_RADIUS + 1)],
                         ids=["block_size", "lk_levels", "max_patches", "lk_radius"])
def test_tracker_refuses_at_construction_what_the_card_refuses(monkeypatch, bad):
    """`EventTracker` on the card (its device resolved as CUDA: the checks
    come before anything is allocated) refuses at construction what the
    frame kernels do not take, not at the first frame's launch; the CPU,
    whose plain versions take any, builds the same tracker."""
    params = tdet.TrackerParams(capacity=32, **bad)
    tdet.EventTracker(params, device="cpu")
    monkeypatch.setattr(tdet._device, "resolve", lambda device=None: torch.device("cuda"))
    with pytest.raises(ValueError, match="the CPU takes any"):
        tdet.EventTracker(params)


def test_kernel_entries_take_the_plain_versions_on_the_cpu_and_refuse_elsewhere():
    """On CPU tensors `frame_maps`, `corner_select`, `harris.detect_corners`,
    `lk.pyramidal_lk`, `detector.frame_rows` and `align.update_num_of_events`
    give their plain versions' results; the kernel-only entries
    (`kernels.frame_rows.frame_rows`, `.track`) refuse a CPU tensor instead
    of falling back."""
    from evo_tpu_torch.kernels import harris
    from evo_tpu_torch.tracker import align

    img = torch.from_numpy(_texture())
    got, ref = kfm.frame_maps(img), kfm.frame_maps_ref(img)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    for a, b in zip(kcs.corner_select(ref[1], **KW), kcs.corner_select_ref(ref[1], **KW)):
        assert torch.equal(a, b)
    for a, b in zip(harris.detect_corners(img, **KW), harris.detect_corners_ref(img, **KW)):
        assert torch.equal(a, b)
    table = _lk_table(list(EDGE_ROWS.values()), np.random.default_rng(2))
    pyr0, pyr1 = _pyramids(_texture(), _texture(*SHIFT))
    a = tdet.frame_rows(table, pyr0, pyr1, ref[0], with_lk=True)
    b = tdet.frame_rows_ref(table, pyr0, pyr1, ref[0], with_lk=True)
    c = align.update_num_of_events(table, ref[0])
    d = align.update_num_of_events_ref(table, ref[0])
    for name in kfr.OUT_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
        assert torch.equal(getattr(c, name), getattr(d, name)), name
    pts = torch.tensor([[60.0, 60.0], [120.0, 90.0]])
    valid = torch.ones(2, dtype=torch.bool)
    img1 = torch.from_numpy(_texture(*SHIFT))
    for x, y in zip(tlk.pyramidal_lk(img, img1, pts, valid),
                    tlk.pyramidal_lk_ref(img, img1, pts, valid)):
        assert torch.equal(x, y)
    with pytest.raises(RuntimeError, match="no kernel"):
        kfr.frame_rows(table, pyr0, pyr1, ref[0], with_lk=True)
    with pytest.raises(RuntimeError, match="no kernel"):
        kfr.track(pyr0, pyr1, pts, valid)
