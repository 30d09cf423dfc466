"""The frame policy's and event routing's kernel sources,
`evo_tpu_torch/csrc/frame_policy.cu` and `route_events.cu`, run on the CPU:
compiled by g++ against the stand-in CUDA headers under
`tests/cuda_emulator/` (as `tests/test_torch_frame_emulated.py` does),
called through the wrappers' own argument packing
(`kernels.frame_policy.run`, `kernels.route_events.run`) and held to the
plain versions (`tracker.policy.frame_policy_ref`,
`tracker.patch_state.route_events_ref`) and to `evo_tpu`'s functions on the
same numpy inputs, bit for bit: both kernels only compare, count and copy
(the policy's one product, a squared distance, rounds as the plain
version's under `-ffp-contract=off`, as the card's `-fmad=false`).

The policy: `tests/test_torch_pipeline.py`'s random tables; equal
distances, where the lower corner index wins, within a row and across rows;
a row whose nearest corner an earlier row claimed; dead rows and a live row
with a NaN centre; invalid corners; exhausted slots, with eviction and ties
of `slot_birth`; an association distance whose candidates overflow a row's
list of 8, and one whose square lies above the masked distance 3.4e38
(every row then takes the argmin over all corners); 2,048 corners and a
capacity of 200; a chain of 120 rows each sharing a corner with the next
(the conflict waves reach 120), the same chain with an overflowing row in
its middle, and groups of rows sharing six corners.
Routing: more than 320 hits for one patch, a wrapped ring, padded events,
events exactly 12 px from the centre, a dead patch, N = 4,096 k, one
patch's hits straddling the 32-event words and the emulated build's
2,048-event chunks, N = 5,001 (not a multiple of 32), N = 0 (which both
plain versions refuse: the kernel must leave the table as it is), P = 1,
every event in one patch's rect, dead patches between live ones, N =
70,000 (above the card build's 65,536-event chunk, a patch's kept hits
straddling it).

The builds run a block as one warp (`-DEVO_FP_THREADS=32`;
`-DEVO_RE_THREADS=32 -DEVO_RE_CLUSTER=2 -DEVO_RE_CHUNK=2048`: clusters of
two patches and sub-batches taken 2,048 events a pass, so longer ones take
the counting pass), which the emulation runs fastest (each barrier is a
turn of every thread it holds); one case of each also runs with two warps
(the routing in clusters of four, in one pass and 2,048 events a pass), so
the block scans and minima cross warps there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu.tracker import patch_state as jps
from evo_tpu.tracker import policy as jpolicy
from evo_tpu_torch.kernels import frame_policy as kfp
from evo_tpu_torch.kernels import route_events as kre
from evo_tpu_torch.tracker import detector as tdet
from evo_tpu_torch.tracker import patch_state as tps
from evo_tpu_torch.tracker import policy as tpolicy
from tests.test_torch_frame_emulated import _compile, ok
from torch_policy_cases import POLICY_CASES, ROUTE_CASES, route_case

torch.set_num_threads(1)

# `evo_tpu`'s two functions, each compiled once a shape (and distance)
jax_policy = jax.jit(jpolicy.frame_policy, static_argnames=("association_distance",))
jax_route = jax.jit(jps.route_events)

FP_BUILD = ("-DEVO_FP_THREADS=32",)
RE_BUILD = ("-DEVO_RE_THREADS=32", "-DEVO_RE_CLUSTER=2", "-DEVO_RE_CHUNK=2048")
TWO_WARPS = {"frame_policy": ("-DEVO_FP_THREADS=64",),
             "route_events": ("-DEVO_RE_THREADS=64", "-DEVO_RE_CLUSTER=4")}


@pytest.fixture(scope="module")
def fp_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("frame_policy"), "frame_policy", kfp._SIGNATURES,
                    *FP_BUILD)


@pytest.fixture(scope="module")
def re_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("route_events"), "route_events", kre._SIGNATURES,
                    *RE_BUILD)


# ---- the policy ---------------------------------------------------------------

def policy_state(slot_birth, next_tid=1000, frame_no=50):
    return tpolicy.PolicyState(slot_birth=torch.as_tensor(np.asarray(slot_birth, np.int32)),
                               next_tid=torch.tensor(next_tid, dtype=torch.int32),
                               frame_no=torch.tensor(frame_no, dtype=torch.int32))


def emulated_policy(lib):
    """`tracker.policy.frame_policy`'s card path with the emulated kernel."""
    def frame_policy(view, state, corners_xy, corners_ok, *, max_patches,
                     association_distance):
        dec, (birth, tid, fno) = kfp.run(
            lib.evo_frame_policy, ok, view, state.slot_birth, state.next_tid, state.frame_no,
            corners_xy, corners_ok, max_patches=max_patches,
            association_distance=association_distance)
        return dec, tpolicy.PolicyState(slot_birth=birth, next_tid=tid, frame_no=fno)
    return frame_policy


def _policies(lib, case: dict, max_patches=100, association_distance=5.0):
    """(kernel, plain, evo_tpu): each (decisions, state) as numpy."""
    kw = dict(max_patches=max_patches, association_distance=association_distance)
    view = tpolicy.TableView(**{k: torch.from_numpy(np.asarray(v)) for k, v in
                                case["view"].items()})
    state = policy_state(case["slot_birth"])
    xy, okc = torch.from_numpy(case["corners"]), torch.from_numpy(case["ok"])
    out = [emulated_policy(lib)(view, state, xy, okc, **kw),
           tpolicy.frame_policy_ref(view, state, xy, okc, **kw)]
    jview = jpolicy.TableView(**{k: jnp.asarray(v) for k, v in case["view"].items()})
    jstate = jpolicy.PolicyState(slot_birth=jnp.asarray(case["slot_birth"], jnp.int32),
                                 next_tid=jnp.asarray(1000, jnp.int32),
                                 frame_no=jnp.asarray(50, jnp.int32))
    out.append(jax_policy(jview, jstate, jnp.asarray(case["corners"]),
                                    jnp.asarray(case["ok"]), **kw))
    return [({k: np.asarray(v) for k, v in dec.items()},
             {k: np.asarray(getattr(st, k)) for k in ("slot_birth", "next_tid", "frame_no")})
            for dec, st in out]


def _assert_same_policy(got, ref, what):
    for part in (0, 1):
        assert got[part].keys() == ref[part].keys(), what
        for k in ref[part]:
            a, b = got[part][k], ref[part][k]
            assert a.dtype == b.dtype and a.shape == b.shape, (what, k, a.dtype, b.dtype)
            assert a.tobytes() == b.tobytes(), (what, k, a, b)


@pytest.mark.parametrize("name", list(POLICY_CASES))
def test_frame_policy_kernel_matches_plain_and_jax(fp_lib, name):
    make, kw = POLICY_CASES[name]
    case = make()
    got, ref, jref = _policies(fp_lib, case, **kw)
    _assert_same_policy(got, ref, f"{name}: kernel against the plain version")
    _assert_same_policy(got, jref, f"{name}: kernel against evo_tpu")
    dec = got[0]
    if name == "equal_distances":  # the lower index won; nothing else claimed
        assert dec["new_mask"].sum() == 4 and not (dec["new_center"] == [53, 50]).all(-1).any()
        assert (dec["new_center"] == [50, 53]).all(-1).any()
        assert not (dec["new_center"] == [150, 104]).all(-1).any()
    if name == "invalid_corners":  # rows 0-5 took the valid corners, the far ones went in
        assert dec["new_mask"].sum() == 3
    if name == "claimed_nearest":  # corners 0 and 1 claimed, corner 2 inserted
        assert dec["new_mask"].sum() == 1
        np.testing.assert_array_equal(dec["new_center"][dec["new_mask"]], [[20.0, 20.0]])
    if name == "dead_and_nan":  # the NaN row and the dead rows claimed nothing
        assert dec["new_mask"].sum() == 2  # max_patches 5, two rows alive
    if name == "exhausted_slots":
        assert int(dec["slot"]) == 5 and dec["evict"].sum() == 1 and dec["evict"][5]
    if name in ("list_overflow", "threshold_above_mask"):
        assert dec["n_new"] < case["ok"].sum()  # rows claimed corners
    if name == "chain":  # row k claimed corner k, down the whole chain
        assert dec["n_new"] == 0
    if name == "overflow_in_chain":  # corner 99 and nine of the crowd left over
        assert dec["n_new"] == 10 and (dec["new_center"] == [8.0 * 99 + 24.5, 50.0]).all(-1).any()


def test_frame_policy_kernel_with_two_warps(tmp_path):
    """The 64-thread build (the block minima and scans across warps) on the
    large case and a random table."""
    lib = _compile(tmp_path, "frame_policy", kfp._SIGNATURES, *TWO_WARPS["frame_policy"])
    for name in ("large", "random5"):
        make, kw = POLICY_CASES[name]
        got, ref, _ = _policies(lib, make(), **kw)
        _assert_same_policy(got, ref, name)


def test_frame_policy_clock_build_keeps_the_bits(tmp_path, fp_lib):
    """The clock build (-DEVO_FP_CLOCKS): the plain build's decisions and
    state, its stages (the emulation's nanoseconds for the card's cycles)
    add up to its total, and its wave count is the longest chain of rows
    that share corners: 120 on the chain, 4 on groups of four rows sharing
    corners, and one a live row where every list overflows."""
    clock = _compile(tmp_path, "frame_policy", kfp._SIGNATURES, *FP_BUILD, "-DEVO_FP_CLOCKS")
    waves = dict(chain=120, shared_corners=4, threshold_above_mask=20)
    for name in ("random2", "list_overflow", "chain", "shared_corners", "threshold_above_mask"):
        make, kw = POLICY_CASES[name]
        case, clk = make(), torch.zeros(len(kfp.CLOCK_SLOTS), dtype=torch.int64)
        kw = dict(dict(max_patches=100, association_distance=5.0), **kw)
        view = tpolicy.TableView(**{k: torch.from_numpy(np.asarray(v)) for k, v in
                                    case["view"].items()})
        state = policy_state(case["slot_birth"])
        args = (view, state.slot_birth, state.next_tid, state.frame_no,
                torch.from_numpy(case["corners"]), torch.from_numpy(case["ok"]))
        got = kfp.run(clock.evo_frame_policy, ok, *args, **kw, clocks=clk)
        ref = kfp.run(fp_lib.evo_frame_policy, ok, *args, **kw)
        for k in kfp.DECISIONS:
            assert torch.equal(got[0][k], ref[0][k]), (name, k)
        for a, b in zip(got[1], ref[1]):
            assert torch.equal(a, b), name
        cycles = clk[:len(kfp.STAGES)]
        assert int(cycles[:-1].sum()) == int(cycles[-1]) > 0 and (clk >= 0).all(), name
        if name in waves:
            assert not ref[0]["evict"].any() and int(clk[-1]) == waves[name], name


# ---- routing ---------------------------------------------------------------------

def _tables(fields):
    t = tps.empty_table(len(fields["alive"]), device="cpu")
    t = t.replace(**{k: torch.from_numpy(v) for k, v in fields.items()})
    j = jps.empty_table(len(fields["alive"]))
    j = dataclasses.replace(j, **{k: jnp.asarray(v) for k, v in fields.items()})
    return t, j


def _check_route(lib, name, seed=0):
    fields, events = route_case(name, np.random.default_rng(seed))
    table, jtable = _tables(fields)
    ev = [torch.from_numpy(a) for a in events]
    got = kre.run(lib.evo_route_events, ok, table, *ev)
    if len(events[0]):
        refs = ((tps.route_events_ref(table, *ev), "plain"),
                (jax_route(jtable, *[jnp.asarray(a) for a in events]), "jax"))
    else:  # an empty sub-batch, which both plain versions refuse: nothing is routed
        refs = ((table, "the input"),)
    for k in kre.RING + ("ev_count", "counter"):
        a = got[k].numpy()
        for ref, what in refs:
            b = np.asarray(getattr(ref, k))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (name, k, what)
    np.testing.assert_array_equal(table.ev_t.numpy(), fields["ev_t"])  # input not written
    return got, table


@pytest.mark.parametrize("name", ROUTE_CASES)
def test_route_events_kernel_matches_plain_and_jax(re_lib, name):
    got, table = _check_route(re_lib, name)
    n_hit = (got["ev_count"] - table.ev_count).numpy()
    if name == "over_320":
        assert n_hit[0] > tps.MAX_EVENTS
    if name == "wrapped":
        assert (n_hit > 100).all()
    if name == "dead":
        assert n_hit[1] == n_hit[4] == 0 and n_hit.sum() > 0
    if name == "at_12px":
        assert n_hit.sum() > 0
    if name in ("one_patch", "p_1", "n_5001"):
        assert n_hit[0] > tps.MAX_EVENTS and n_hit[1:].sum() == 0
    if name == "dead_between":
        assert (n_hit[[1, 3, 4]] == 0).all() and (n_hit[[0, 2, 5]] > tps.MAX_EVENTS).all()
    if name == "n_70000":
        assert (n_hit > tps.MAX_EVENTS).all()


def test_route_events_kernel_with_two_warps(tmp_path):
    """The 64-thread build in clusters of four and one pass (the block
    scans across the warps) on the wrapped rings."""
    lib = _compile(tmp_path, "route_events", kre._SIGNATURES, *TWO_WARPS["route_events"])
    _check_route(lib, "wrapped", seed=1)


def test_route_events_kernel_with_two_warps_in_chunks(tmp_path):
    """The 64-thread build in clusters of four taking 2,048 events a pass:
    the counting pass's block scan across the warps, on the hits that
    straddle the chunks."""
    lib = _compile(tmp_path, "route_events", kre._SIGNATURES, *TWO_WARPS["route_events"],
                   "-DEVO_RE_CHUNK=2048")
    _check_route(lib, "straddle", seed=1)


def test_route_events_clock_build_keeps_the_bits(tmp_path, re_lib):
    """The clock build (-DEVO_RE_CLOCKS): the plain build's rings and
    counts, and each block's stages add up to its total."""
    clock = _compile(tmp_path, "route_events", kre._SIGNATURES, *RE_BUILD, "-DEVO_RE_CLOCKS")
    fields, events = route_case("wrapped", np.random.default_rng(2))
    table, _ = _tables(fields)
    ev = [torch.from_numpy(a) for a in events]
    clk = torch.zeros((table.capacity, len(kre.STAGES)), dtype=torch.int64)
    got = kre.run(clock.evo_route_events, ok, table, *ev, clocks=clk)
    ref = kre.run(re_lib.evo_route_events, ok, table, *ev)
    for k in kre.RING + ("ev_count", "counter"):
        assert torch.equal(got[k], ref[k]), k
    assert torch.equal(clk[:, :-1].sum(1), clk[:, -1]) and (clk[:, -1] > 0).all()
    assert (clk >= 0).all()


def test_route_events_kernel_refuses_a_ring_beyond_its_block(re_lib):
    """A ring longer than `kernels.route_events.MAX_RING` slots (a block
    holds an event index for each slot of its patch's ring) is refused
    before a launch, and by the C entry itself; the longest ring it takes
    is routed."""
    import array

    def never(*args):
        raise AssertionError("launched")

    ev = [torch.zeros(64), torch.zeros(64), torch.zeros(64), torch.zeros(64),
          torch.ones(64, dtype=torch.bool)]
    with pytest.raises(ValueError, match="rings of 1 to"):
        kre.run(re_lib.evo_route_events, never, tps.empty_table(2, kre.MAX_RING + 1,
                                                                 device="cpu"), *ev)
    ptrs = array.array("Q", [0] * len(kre.POINTERS))
    assert re_lib.evo_route_events(ptrs.buffer_info()[0], 2, kre.MAX_RING + 1, 64, None) != 0
    table = tps.empty_table(2, kre.MAX_RING, device="cpu")
    table = table.replace(alive=torch.ones(2, dtype=torch.bool),
                          ev_count=torch.tensor([5, kre.MAX_RING - 3], dtype=torch.int32))
    got = kre.run(re_lib.evo_route_events, ok, table, *ev)
    ref = tps.route_events_ref(table, *ev)
    for k in kre.RING + ("ev_count", "counter"):
        assert torch.equal(got[k], getattr(ref, k)), k


# ---- the entries ---------------------------------------------------------------

def test_entries_take_the_plain_versions_on_the_cpu_and_refuse_elsewhere():
    """On CPU tensors `policy.frame_policy` and `patch_state.route_events`
    give their plain versions' results; the kernel entries
    (`kernels.frame_policy.frame_policy`, `kernels.route_events.route_events`)
    refuse a CPU tensor instead of falling back."""
    case = POLICY_CASES["random0"][0]()
    view = tpolicy.TableView(**{k: torch.from_numpy(v) for k, v in case["view"].items()})
    state = policy_state(case["slot_birth"])
    xy, okc = torch.from_numpy(case["corners"]), torch.from_numpy(case["ok"])
    a = tpolicy.frame_policy(view, state, xy, okc, max_patches=100, association_distance=5.0)
    b = tpolicy.frame_policy_ref(view, state, xy, okc, max_patches=100,
                                 association_distance=5.0)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    fields, events = route_case("wrapped", np.random.default_rng(0))
    table, _ = _tables(fields)
    ev = [torch.from_numpy(x) for x in events]
    c, d = tps.route_events(table, *ev), tps.route_events_ref(table, *ev)
    for k in kre.RING + ("ev_count", "counter"):
        assert torch.equal(getattr(c, k), getattr(d, k)), k
    with pytest.raises(RuntimeError, match="no kernel"):
        kfp.frame_policy(view, state.slot_birth, state.next_tid, state.frame_no, xy, okc,
                         max_patches=100, association_distance=5.0)
    with pytest.raises(RuntimeError, match="no kernel"):
        kre.route_events(table, *ev)


def test_tracker_refuses_a_capacity_beyond_the_policy_kernel(monkeypatch):
    """`EventTracker` on the card refuses at construction a capacity whose
    rows the policy kernel's block cannot hold; the CPU builds it."""
    params = tdet.TrackerParams(capacity=kfp.MAX_ROWS + 1)
    tdet.EventTracker(params, height=8, width=8, device="cpu")
    monkeypatch.setattr(tdet._device, "resolve", lambda device=None: torch.device("cuda"))
    with pytest.raises(ValueError, match="the CPU takes any"):
        tdet.EventTracker(params, height=8, width=8)
