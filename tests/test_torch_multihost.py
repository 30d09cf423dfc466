"""The rest of the port's `dist/multihost.py` on the CPU: `parity_worker`,
`measure_scaling`, `measure_scaling_pipeline` and `write_scaling_artifact`,
the twins of tests/test_dist.py's TestMultiprocess and TestScaling.

One world of 2 gloo ranks for the whole run (`write_scaling_artifact`, one
CPU thread per rank, shared by the test workers as tests/test_torch_dist.py
shares its world) runs the three: the parity check in both ranks, then the
decode, window-scan and tile-solve timings at rank counts 1 and 2 at small
sizes. The bars are the JAX package's agreement bars: the decode 2e-4 and
the scan 2e-3 (`parity_worker`, as `_mp_worker`), the sharded decode image
2e-3 (TestShardedSplat), the scan costs 2e-3, the tile solve's initial cost
1e-5 relative and its velocities 5e-3 (TestShardedTileSolve). No efficiency
bound is asserted: gloo ranks on a CPU that six test workers share say
nothing about speed, and a time bound there would make the test count
depend on the host's load (tests/test_dist.py keeps its bounds for
`evo_tpu`)."""

import hashlib
import math
import os

import pytest

from evo_tpu_torch.dist import multihost
from tests.test_torch_dist import once_per_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALING_JSON = os.path.join(ROOT, "SCALING.json")
SIZES = dict(scaling=dict(events_per_rank=1 << 12, repeats=1),
             pipeline=dict(repeats=1, patches_per_rank=8, events_per_window=2048,
                           tile_events=40_000, tile_iters=2))


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(the artifact, its path, SCALING.json's digest before and after)."""
    def compute():
        before = _digest(SCALING_JSON)
        path = str(tmp_path_factory.mktemp("scaling") / "s.json")
        out = multihost.write_scaling_artifact(path, counts=(1, 2), device="cpu", threads=1,
                                               timeout_s=400.0, **SIZES)
        with open(path) as f:
            written = f.read()
        return out, written, before, _digest(SCALING_JSON)

    return once_per_run(tmp_path_factory, "torch_multihost_world", compute)


def test_parity_worker_in_two_ranks(artifact):
    """TestMultiprocess: the sharded decode and window scan across two
    processes against one rank's computation."""
    ranks = artifact[0]["multiprocess"]["ranks"]
    assert {r["process_id"] for r in ranks} == {0, 1}
    for r in ranks:
        assert r["num_processes"] == 2 and r["global_devices"] == 2
        assert r["local_devices"] == 1 and r["device"] == "cpu" and r["backend"] == "gloo"
        assert r["decode_max_abs_err"] < 2e-4, r
        assert r["scan_max_abs_err"] < 2e-3, r
        assert r["ok"], r
    assert artifact[0]["multiprocess"]["ok"]


def _positive(*xs):
    return all(math.isfinite(x) and x > 0 for x in xs)


def test_measure_scaling(artifact):
    """TestScaling: the decode's rows at 1 and 2 ranks carry the JAX keys,
    positive finite times, and the sharded image is the one-rank image."""
    rows = artifact[0]["scaling"]
    assert set(rows) == {"1", "2"}
    for row in rows.values():
        assert set(row) >= {"mev_per_s", "efficiency", "comm_efficiency",
                            "ms_sharded", "ms_single"}
        assert _positive(row["mev_per_s"], row["efficiency"], row["comm_efficiency"],
                         row["ms_sharded"], row["ms_single"])
        assert row["max_abs_err"] < 2e-3
    assert rows["1"]["efficiency"] == 1.0


def test_measure_scaling_pipeline(artifact):
    """TestScaling: the window scan's and the tile solve's rows, their keys,
    positive finite times, and sharded results that agree with one rank's."""
    pipe = artifact[0]["pipeline_collectives"]
    assert set(pipe) == {"window_scan", "tile_solve"}
    for n, row in pipe["window_scan"].items():
        assert row["patches"] == 8 * int(n)
        assert _positive(row["ms_sharded"], row["ms_single"], row["comm_efficiency"])
        assert row["cost_max_abs_err"] < 2e-3
    assert set(pipe["tile_solve"]) == {"1", "2"}
    for row in pipe["tile_solve"].values():
        assert row["tiles"] == 12 * 16
        assert _positive(row["ms_sharded"], row["ms_single"], row["comm_efficiency"])
        (c0_sh, c0_1), (c_sh, _) = row["cost0"], row["cost"]
        assert c0_1 > 0 and c_sh <= c0_sh + 1e-3
        assert c0_sh == pytest.approx(c0_1, rel=1e-5)
        assert row["vel_max_abs_err"] < 5e-3


def test_write_scaling_artifact_writes_only_where_it_is_told(artifact):
    """The artifact goes to the caller's path and SCALING.json (`evo_tpu`'s
    numbers) keeps its bytes; without a path the call is refused."""
    out, written, before, after = artifact
    import json

    assert json.loads(written) == json.loads(json.dumps(out))
    assert out["n_ranks"] == 2 and out["backend"] == "gloo"
    assert before == after
    with pytest.raises(TypeError):
        multihost.write_scaling_artifact()  # noqa: the path is required
    with pytest.raises(SystemExit):
        multihost.main([])


def test_measurements_take_one_world_of_the_largest_count(monkeypatch):
    """`measure_scaling` and `measure_scaling_pipeline` launch one world of
    max(counts) ranks that measures every count (nothing is spawned here)."""
    calls = []

    def fake_launch(worker, n, args, **kw):
        calls.append((worker, n, args, kw))
        return [{"scaling": {1: {}}, "pipeline": {"window_scan": {}}}] * n

    monkeypatch.setattr(multihost, "launch", fake_launch)
    assert multihost.measure_scaling((1, 2, 4), device="cpu", repeats=1) == {1: {}}
    assert multihost.measure_scaling_pipeline((2, 1), device="cpu", threads=1) == {
        "window_scan": {}}
    (w0, n0, a0, k0), (w1, n1, a1, k1) = calls
    assert w0 is w1 is multihost._world_rank and (n0, n1) == (4, 2)
    assert a0 == ({"scaling": ((1, 2, 4), {"repeats": 1})}, "cpu", None)
    assert a1 == ({"pipeline": ((2, 1), {})}, "cpu", 1)
    assert k0["device"] == "cpu"
