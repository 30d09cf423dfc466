"""Inputs of the frame policy's and the event routing's kernel tests, made
with numpy from seeds: `POLICY_CASES` (name -> (the case's maker, the
policy's keyword arguments); a case is the table's view, the slots' births
and the corners as numpy) and `route_case` (`ROUTE_CASES`). It imports no
JAX, so the card's tests (`tests/test_torch_gpu.py`) take the same inputs as
the emulated ones (`tests/test_torch_policy_emulated.py`); the test files
import it as `import torch_policy_cases`.
"""

import numpy as np

from evo_tpu_torch.tracker import patch_state as tps

# the table's rows and the gradient slots, as in both packages
P = tps.MAX_PATCHES


def random_table(rng, n_alive=40, n_corners=60, exhaust_slots=False):
    """A randomized control state: the four table fields the policy reads,
    host slot bookkeeping consistent with them, corners."""
    alive = np.zeros(P, bool)
    alive[rng.choice(P, n_alive, replace=False)] = True
    center = rng.uniform(15, 160, (P, 2)).astype(np.float32)
    track_id = np.where(alive, rng.permutation(P).astype(np.int32), -1).astype(np.int32)
    grad_slot = rng.integers(0, 8, P).astype(np.int32)
    if exhaust_slots:  # every slot referenced by a live patch: eviction
        alive = np.ones(P, bool)
        grad_slot = (np.arange(P) % P).astype(np.int32)
        track_id = np.arange(P, dtype=np.int32)
    refcount = np.bincount(grad_slot[alive], minlength=P).astype(np.int64)
    slot_birth = np.where(refcount > 0, rng.integers(0, 50, P), -1)
    corners = rng.uniform(14, 165, (n_corners, 2)).astype(np.float32)
    # some corners within reach of live patches, so association has work
    near = rng.choice(np.flatnonzero(alive), min(10, n_corners, int(alive.sum())), replace=False)
    corners[: len(near)] = center[near] + rng.uniform(-3, 3, (len(near), 2)).astype(np.float32)
    ok = rng.random(n_corners) < 0.9
    return dict(alive=alive, center=center, track_id=track_id, grad_slot=grad_slot,
                refcount=refcount, slot_birth=slot_birth.astype(np.int64),
                corners=corners, ok=ok)


# every case but `large` at one shape (128 rows and slots, 128 corners: the
# corners padded with invalid zeros), so that `evo_tpu`'s policy compiles once
C = 128


def _padded(corners, ok, c=C):
    n = len(corners)
    return (np.concatenate([corners, np.zeros((c - n, 2))]).astype(np.float32),
            np.concatenate([ok, np.zeros(c - n, bool)]))


def _case_random(seed, **kw):
    s = random_table(np.random.default_rng(seed), **kw)
    corners, ok = _padded(s["corners"], s["ok"])
    return dict(view={k: s[k] for k in ("alive", "center", "track_id", "grad_slot")},
                slot_birth=s["slot_birth"], corners=corners, ok=ok)


def _table(alive, center, slots=None, n=P):
    alive = np.zeros(n, bool) | np.asarray(alive, bool)
    return dict(alive=alive, center=np.asarray(center, np.float32),
                track_id=np.where(alive, np.arange(n), -1).astype(np.int32),
                grad_slot=np.zeros(n, np.int32) if slots is None else np.asarray(slots, np.int32))


def _grid_centres(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(20, 220, n), rng.uniform(20, 160, n)], -1).astype(np.float32)


def _case_equal_distances():
    """Row 3's three corners at 3 px, equal distances: the lower index wins;
    row 7 has two at 4 px, the later one listed first."""
    c = _grid_centres(P)
    c[3], c[7] = (50.0, 50.0), (150.0, 100.0)
    corners, ok = _padded(np.array([[10.0, 10.0], [53.0, 50.0], [47.0, 50.0], [50.0, 53.0],
                                    [150.0, 104.0], [146.0, 100.0]]), np.ones(6, bool))
    return dict(view=_table([k in (3, 7) for k in range(P)], c), slot_birth=np.full(P, -1),
                corners=corners, ok=ok)


def _case_claimed_nearest():
    """Rows 2 and 5 are both nearest to corner 1; row 2 claims it first, so
    row 5 takes corner 0, farther; row 9's only candidate is claimed too."""
    c = _grid_centres(P, 1)
    c[2], c[5], c[9] = (100.0, 100.0), (101.0, 101.0), (99.0, 98.0)
    corners, ok = _padded(np.array([[103.5, 101.0], [100.5, 100.5], [20.0, 20.0]]),
                          np.ones(3, bool))
    return dict(view=_table([k in (2, 5, 9) for k in range(P)], c), slot_birth=np.full(P, -1),
                corners=corners, ok=ok)


def _case_dead_and_nan():
    """Dead rows on top of corners claim nothing; a live row with a NaN
    centre claims nothing; a dead row's slot is free again."""
    c = _grid_centres(P, 2)
    corners, ok = _padded(c[:4] + 0.5, np.ones(4, bool))
    c[6] = (np.nan, 60.0)
    return dict(view=_table([k in (1, 6, 8) for k in range(P)], c, slots=np.arange(P) % 3),
                slot_birth=np.array([3, 1, 2] + [-1] * (P - 3)), corners=corners, ok=ok)


def _case_invalid_corners():
    """The nearest corners of live rows are invalid (and padded at 0): the
    rows take the valid ones behind them, and no invalid corner is
    inserted."""
    c = _grid_centres(P, 3)
    far = np.array([[5.0, 5.0], [230.0, 170.0], [120.0, 5.0]], np.float32)
    ok = np.ones(15, bool)
    ok[:6] = False
    corners, ok = _padded(np.concatenate([c[:6] + 0.25, c[:6] + 2.0, far]), ok)
    return dict(view=_table(np.arange(P) < 8, c), slot_birth=np.full(P, -1), corners=corners,
                ok=ok)


def _case_exhausted_slots():
    """Every slot referenced by a live row: the oldest slot, the first of
    three tied births, is evicted with its rows."""
    c = _grid_centres(P, 4)
    birth = np.arange(P) + 10
    birth[[5, 9, 17]] = 2
    rng = np.random.default_rng(5)
    corners, ok = _padded(np.concatenate([c[[5, 9, 4]] + 1.0, rng.uniform(20, 160, (10, 2))]),
                          np.ones(13, bool))
    return dict(view=_table(np.ones(P, bool), c, slots=np.arange(P)), slot_birth=birth,
                corners=corners, ok=ok)


def _case_crowded(seed=6):
    """Forty corners within 6 px of twenty live rows: with an association
    distance of 60 every row's candidates overflow its list."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(90, 110, (P, 2)).astype(np.float32)
    corners, ok = _padded(rng.uniform(94, 106, (40, 2)), rng.random(40) < 0.9)
    return dict(view=_table(np.arange(P) < 20, c), slot_birth=np.full(P, -1), corners=corners,
                ok=ok)


def _case_large():
    """2,048 corners (the kernel's most) and a capacity of 200."""
    n = 200
    rng = np.random.default_rng(7)
    c = _grid_centres(n, 7)
    corners = rng.uniform(0, 240, (2048, 2)).astype(np.float32)
    corners[:150] = c[:150] + rng.uniform(-4, 4, (150, 2)).astype(np.float32)
    ok = rng.random(2048) < 0.7
    corners[~ok] = 0.0
    return dict(view=_table(rng.random(n) < 0.5, c, slots=rng.integers(0, n, n), n=n),
                slot_birth=rng.integers(-1, 60, n), corners=corners, ok=ok)


def _case_chain(n=120, crowd_at=None):
    """n live rows 8 px apart on a line, corner k 4.5 px right of row k: row
    k lists corners k - 1 (3.5 px) and k, so each row shares a corner with
    the next and the chain of claims runs through all n rows (the waves
    reach n); row k claims corner k, and a corner left unclaimed would be
    inserted into the free rows after them. `crowd_at`: ten more corners
    within 0.25 px of that row, whose list then overflows in the middle of
    the chain: it claims one of them, each row after it corner k - 1, and
    corner n - 1 and nine of the crowd go into free rows."""
    c = np.zeros((P, 2), np.float32)
    c[:n] = np.stack([8.0 * np.arange(n) + 20.0, np.full(n, 50.0)], -1)
    corners = np.stack([8.0 * np.arange(n) + 24.5, np.full(n, 50.0)], -1)
    if crowd_at is not None:
        ang = np.linspace(0, 2 * np.pi, 10, endpoint=False)
        crowd = c[crowd_at] + 0.25 * np.stack([np.cos(ang), 1.0 + np.sin(ang)], -1)
        corners = np.concatenate([corners, crowd])
    corners, ok = _padded(corners, np.ones(len(corners), bool))
    return dict(view=_table(np.arange(P) < n, c), slot_birth=np.full(P, -1), corners=corners,
                ok=ok)


def _case_shared_corners():
    """Groups of four rows within 1 px of each other around six corners
    within 2 px: every row of a group lists all six, so each row waits on
    the rows before it in its group; the groups interleave in row order."""
    rng = np.random.default_rng(8)
    hubs = np.array([[40.0, 40.0], [120.0, 60.0], [200.0, 140.0], [60.0, 150.0]])
    c = _grid_centres(P, 8)
    rows = np.arange(16)  # row r in group r % 4
    c[rows] = hubs[rows % 4] + rng.uniform(-1, 1, (16, 2))
    corners = np.concatenate([h + rng.uniform(-2, 2, (6, 2)) for h in hubs])
    corners, ok = _padded(corners, np.ones(len(corners), bool))
    return dict(view=_table(np.arange(P) < 16, c), slot_birth=np.full(P, -1), corners=corners,
                ok=ok)


def _case_equal_across_rows():
    """Rows 10 and 11 at 2 px either side of corner 0: the earlier row
    claims it and row 11 takes corner 1, farther; rows 20 and 21 each have
    corners 2 and 3 at equal distances (row 20 both at 3 px, the lower index
    wins; row 21 takes the other); row 30 and row 31 tie on corner 4 with a
    NaN-free zero distance; corners 5 and 6 lie out of reach and are
    inserted."""
    c = _grid_centres(P, 9)
    c[10], c[11] = (100.0, 100.0), (104.0, 100.0)
    c[20], c[21] = (150.0, 50.0), (150.0, 52.0)
    c[30], c[31] = (30.0, 150.0), (30.0, 150.0)
    corners, ok = _padded(np.array([[102.0, 100.0], [107.0, 100.0], [147.0, 50.0],
                                    [153.0, 50.0], [30.0, 150.0], [200.0, 20.0],
                                    [10.0, 10.0]]), np.ones(7, bool))
    return dict(view=_table([k in (10, 11, 20, 21, 30, 31) for k in range(P)], c),
                slot_birth=np.full(P, -1), corners=corners, ok=ok)


POLICY_CASES = {
    **{f"random{k}": (lambda k=k, kw=kw: _case_random(k, **kw), {}) for k, kw in enumerate(
        [{}, {}, dict(n_alive=70, n_corners=100), dict(n_alive=5, n_corners=30),
         dict(n_alive=95, n_corners=80), dict(exhaust_slots=True)])},
    "equal_distances": (_case_equal_distances, dict(association_distance=5.0)),
    "claimed_nearest": (_case_claimed_nearest, dict(association_distance=5.0)),
    "dead_and_nan": (_case_dead_and_nan, dict(max_patches=5)),
    "invalid_corners": (_case_invalid_corners, {}),
    "exhausted_slots": (_case_exhausted_slots, {}),
    "list_overflow": (_case_crowded, dict(association_distance=60.0)),
    "threshold_above_mask": (_case_crowded, dict(association_distance=1.8446e19)),
    "large": (_case_large, dict(max_patches=150)),
    "chain": (_case_chain, dict(max_patches=200)),
    "overflow_in_chain": (lambda: _case_chain(100, crowd_at=64), dict(max_patches=200)),
    "shared_corners": (_case_shared_corners, {}),
    "equal_across_rows": (_case_equal_across_rows, {}),
}


# the cases' patches and events where they differ from 6 and 8,192
ROUTE_SHAPES = {"n_5001": (6, 5001), "n_0": (6, 0), "p_1": (1, 8192), "n_70000": (6, 70000)}


def route_case(name, rng):
    """(table fields as numpy, events ex, ey, et, ep, mask) of a case."""
    e = tps.MAX_EVENTS
    p, n = ROUTE_SHAPES.get(name, (6, 8192))  # 4,096 k, as a dense window's sub-batches
    alive = np.ones(p, bool)
    center = np.stack([rng.uniform(30, 210, p), rng.uniform(30, 150, p)], -1).astype(np.float32)
    ev_count = rng.integers(0, 400, p).astype(np.int32)
    ex = rng.integers(0, 240, n).astype(np.float32)
    ey = rng.integers(0, 180, n).astype(np.float32)
    mask = np.ones(n, bool)
    if name == "over_320":  # a third of the events inside patch 0's rect
        ex[::3] = center[0, 0] + rng.integers(-12, 13, len(ex[::3]))
        ey[::3] = center[0, 1] + rng.integers(-12, 13, len(ey[::3]))
    if name == "wrapped":  # rings whose kept hits run over slot E - 1
        ev_count[:] = [319, 300, 637, 1, 0, 2 ** 30]
        for k in range(p):
            ex[k::p] = center[k, 0] + rng.integers(-8, 9, len(ex[k::p]))
            ey[k::p] = center[k, 1] + rng.integers(-8, 9, len(ey[k::p]))
    if name == "padded":  # the padding lies inside the rects
        mask[n // 2:] = False
        ex[n // 2:] = center[np.arange(n - n // 2) % p, 0]
        ey[n // 2:] = center[np.arange(n - n // 2) % p, 1]
    if name == "at_12px":  # on the rect's edge, and one ulp beyond it
        center[:] = np.round(center) + 0.5
        k = np.arange(n) % p
        side = rng.integers(0, 4, n)
        ex[:] = center[k, 0] + np.where(side == 0, 12.0, np.where(side == 1, -12.0, 0.0))
        ey[:] = center[k, 1] + np.where(side == 2, 12.0, np.where(side == 3, -12.0, 0.0))
        far = rng.random(n) < 0.3
        ex[far & (side < 2)] = np.nextafter(ex[far & (side < 2)], np.float32(1e9))
        ey[far & (side >= 2)] = np.nextafter(ey[far & (side >= 2)], np.float32(-1e9))
    if name == "dead":  # events on a dead patch and on a live one
        alive[[1, 4]] = False
        ex[::2] = center[[1, 4] * (n // 4), 0][: len(ex[::2])]
        ey[::2] = center[[1, 4] * (n // 4), 1][: len(ey[::2])]
    if name == "n_4096k":  # a bucket's padding after its events
        mask[7000:] = False
    if name == "straddle":  # patch 0's hits on both sides of each 32-event word's edge and
        # of the 2,048-event chunks of the emulated build
        k = np.arange(n)
        edge = (k % 32 >= 29) | (k % 32 <= 2) | (np.abs(k % 2048 - 1024) > 1020)
        ex[edge] = center[0, 0] + rng.integers(-12, 13, int(edge.sum()))
        ey[edge] = center[0, 1] + rng.integers(-12, 13, int(edge.sum()))
    if name in ("n_5001", "p_1", "one_patch"):  # every event in patch 0's rect: more
        # than E hits, and for P = 1 the cluster's other blocks without a patch
        ex[:] = center[0, 0] + rng.integers(-12, 13, n)
        ey[:] = center[0, 1] + rng.integers(-12, 13, n)
        mask[::7] = False
    if name == "dead_between":  # live patches 0, 2, 5 on top of dead 1, 3, 4
        alive[[1, 3, 4]] = False
        center[[1, 3, 4]] = center[[0, 2, 5]] + 1.0
        ex[:] = center[np.arange(n) % p, 0] + rng.integers(-10, 11, n)
        ey[:] = center[np.arange(n) % p, 1] + rng.integers(-10, 11, n)
    if name == "n_70000":  # above the card's chunk of 65,536 events: every patch's hits
        # in both chunks, patch 0's kept hits straddling the chunks' boundary
        for k in range(p):
            ex[k::p] = center[k, 0] + rng.integers(-12, 13, len(ex[k::p]))
            ey[k::p] = center[k, 1] + rng.integers(-12, 13, len(ey[k::p]))
        tail = np.arange(n) >= 65536 + 150  # no hit of patch 0 from here: moved outside
        ex[tail & (np.abs(ex - center[0, 0]) <= 12) & (np.abs(ey - center[0, 1]) <= 12)] = 500.0
        mask[::11] = False
    fields = dict(alive=alive, center=center, ev_count=ev_count,
                  counter=rng.integers(0, 40, p).astype(np.int32),
                  **{k: rng.random((p, e)).astype(np.float32)
                     for k in ("ev_t", "ev_x", "ev_y", "ev_p")})
    et = np.sort(rng.random(n)).astype(np.float32)
    ep = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return fields, (ex, ey, et, ep, mask)


ROUTE_CASES = ("over_320", "wrapped", "padded", "at_12px", "dead", "n_4096k", "straddle",
               "n_5001", "n_0", "p_1", "one_patch", "dead_between", "n_70000")
