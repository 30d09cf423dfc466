"""The port's frame path (gradients, Harris, pyramidal LK) against the JAX
package's on the same numpy images: a smooth analytic texture and the same
texture translated by a sub-pixel shift.

Tolerances: gradient images atol 1e-5 (float32 convolutions in another
summation order); the Harris corner set identical; LK flow within 1e-3 px
with identical status."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu.kernels import gradients as jgrad
from evo_tpu.kernels import harris as jharris
from evo_tpu.kernels import lk as jlk
from evo_tpu.tracker import detector as jdet
from evo_tpu_torch.kernels import frame_maps as tfm
from evo_tpu_torch.kernels import gradients as tgrad
from evo_tpu_torch.kernels import harris as tharris
from evo_tpu_torch.kernels import lk as tlk
from evo_tpu_torch.tracker import detector as tdet

torch.set_num_threads(1)

H, W = 180, 240
SHIFT = (1.7, -0.8)  # (dx, dy) px between the two frames


def _texture(dx=0.0, dy=0.0):
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    u, v = xx - dx, yy - dy
    img = np.zeros((H, W))
    for _ in range(30):
        cx, cy = rng.uniform(10, W - 10), rng.uniform(10, H - 10)
        s = rng.uniform(3, 7)
        img += rng.uniform(0.3, 1.0) / (1 + np.exp((np.maximum(abs(u - cx), abs(v - cy)) - s) / 0.7))
    img += 0.1 * np.sin(0.31 * u + 0.17 * v)
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


@pytest.fixture(scope="module")
def frames():
    return _texture(), _texture(*SHIFT)


def test_gradients_match_jax(frames):
    img = frames[0]
    np.testing.assert_allclose(tdet.compute_grads(torch.from_numpy(img)).numpy(),
                               np.asarray(jdet._compute_grads(jnp.asarray(img))),
                               atol=1e-5)
    ours = tgrad.image_pyramid(torch.from_numpy(img), 3)
    ref = jgrad.image_pyramid(jnp.asarray(img), 3)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(
        tharris.harris_response(torch.from_numpy(img)).numpy(),
        np.asarray(jharris.harris_response(jnp.asarray(img))), atol=1e-5)


def test_detect_corners_same_set(frames):
    img = frames[0]
    kw = dict(max_corners=30, quality_level=0.01, min_distance=10.0, border=13)
    xy_t, score_t, ok_t = tharris.detect_corners(torch.from_numpy(img), **kw)
    xy_j, score_j, ok_j = (np.asarray(a) for a in
                           jharris.detect_corners(jnp.asarray(img), **kw))
    assert ok_t.sum() >= 8
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(xy_t, xy_j)
    np.testing.assert_allclose(score_t, score_j, rtol=1e-4, atol=1e-7)


def test_pyramidal_lk_matches_jax(frames):
    img0, img1 = frames
    xy, _, ok = (t.numpy() for t in tharris.detect_corners(torch.from_numpy(img0),
                                                            max_corners=24))
    pts = xy.copy()
    pts[~ok] = [3.0, 3.0]  # invalid rows: near the border, status must say lost
    valid = ok.copy()
    valid[-1] = False
    _, flow_j, st_j = jlk.pyramidal_lk(jnp.asarray(img0), jnp.asarray(img1),
                                      jnp.asarray(pts), jnp.asarray(valid))
    _, flow_t, st_t = tlk.pyramidal_lk(torch.from_numpy(img0), torch.from_numpy(img1),
                                      torch.from_numpy(pts), torch.from_numpy(valid))
    st_j = np.asarray(st_j)
    np.testing.assert_array_equal(st_t.numpy(), st_j)
    assert st_j.sum() >= 6
    np.testing.assert_allclose(flow_t.numpy()[st_j], np.asarray(flow_j)[st_j], atol=1e-3)
    # and the flow is the true shift
    np.testing.assert_allclose(np.median(flow_t.numpy()[st_j], axis=0), SHIFT, atol=0.1)


def test_frame_analyze_on_the_cpu_takes_any_block_and_depth(frames):
    """On the CPU the frame's maps are the plain versions, so a Harris box
    other than the kernel's 3x3 and a pyramid deeper than its three levels
    still give the reference's corners and levels."""
    img = frames[0]
    kw = dict(max_corners=30, quality_level=0.01, min_distance=10.0, border=13)
    xy_t, ok_t, maps = tdet.frame_analyze(torch.from_numpy(img), block_size=5, **kw)
    xy_j, _, ok_j = (np.asarray(a) for a in
                     jharris.detect_corners(jnp.asarray(img), block_size=5, **kw))
    assert ok_t.sum() >= 8
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    np.testing.assert_array_equal(xy_t.numpy(), xy_j)
    ours = tfm.pyramid(torch.from_numpy(img), maps, 4)
    ref = jgrad.image_pyramid(jnp.asarray(img), 4)
    assert len(ours) == 4
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _peaks(values: dict, h: int = 60, w: int = 80):
    """A response [h, w] of single-pixel peaks {(x, y): value} on zeros."""
    resp = torch.zeros(h, w)
    for (x, y), v in values.items():
        resp[y, x] = v
    return resp


# (peaks of the plain path's response, the pixel the kernels' path raised by
# 4e-6 or None, the kernels' ranked corners where given by hand, explained)
_SWAPS = {
    # two far apart corners 2e-6 apart swap their ranks
    "swap": ({(20, 20): 1.0, (40, 20): 0.5, (60, 20): 0.5 - 2e-6, (20, 40): 0.3},
             (60, 20), None, True),
    # the swap lets the lower one suppress the upper one and, through it,
    # a third corner within min_distance of it only
    "cascade": ({(20, 20): 1.0, (40, 20): 0.5, (45, 20): 0.5 - 2e-6, (53, 20): 0.4},
                (45, 20), None, True),
    # a candidate 2e-6 above the quality threshold (0.01 x the largest) is
    # not a corner on the kernels' path
    "threshold": ({(20, 20): 1.0, (40, 20): 0.5, (60, 40): 0.01 + 2e-6}, None,
                  [(20, 20), (40, 20)], True),
    # a corner dropped for one far below it: each has a near-equal partner,
    # but not the one it displaced
    "unrelated": ({(20, 20): 1.0, (40, 20): 0.3 + 1e-6, (60, 20): 0.3,
                   (20, 40): 0.1 + 1e-6, (40, 40): 0.1}, None,
                  [(20, 20), (40, 20), (20, 40), (40, 40)], False),
}


@pytest.mark.parametrize("case", list(_SWAPS))
def test_corner_sets_pair_each_swap_with_the_corner_it_displaced(case):
    """`time_frames.explain_apart`, the smoke's escape for corner sets that
    part between the kernels' and the plain path's responses: a difference
    passes only where each corner the kernels' path ranks in another's place
    lies within 1e-5 of that one (or of the threshold), and the rest of the
    set follows from those swaps."""
    from evo_tpu_torch.kernels import corner_select as cs
    from evo_tpu_torch.run import time_frames

    values, raised, by_hand, explained = _SWAPS[case]
    resp = _peaks(values)
    kw = dict(max_corners=100, quality_level=0.01, min_distance=10.0, border=13)
    if by_hand is None:
        moved = _peaks({p: v + 4e-6 if p == raised else v for p, v in values.items()})
        xy, _, ok = cs.corner_select_ref(moved, **kw)
        by_hand = [tuple(int(c) for c in p) for p in xy[ok].tolist()]
    w = resp.shape[1]
    got = [y * w + x for x, y in by_hand]
    ref = cs.corner_select_ref(resp, **kw)
    assert [tuple(int(c) for c in p) for p in ref[0][ref[2]].tolist()] != by_hand
    out = time_frames.explain_apart(got, resp, **kw)
    assert out["explained"] is explained
    assert out["pairs"] and all((p["gap"] <= 1e-5) is (explained or k + 1 < len(out["pairs"]))
                                for k, p in enumerate(out["pairs"]))
