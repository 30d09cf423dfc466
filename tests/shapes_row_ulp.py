"""How far `evo_tpu`'s `shapes` row moves from itself when the written
events' timestamps move by one float32 ulp.

    env JAX_PLATFORMS=cpu python tests/shapes_row_ulp.py [OUT_DIR]

`tests/test_torch_viz_quality.py::test_shapes_row_on_one_dataset_matches_jax`
scores the `shapes` row (the tracker experiment on the 48-polygon scene, no
compensation, scored against the plane at 2 m) through both packages on one
dataset written by the port's simulator, and finds them apart by more than
its tolerances. This script runs `evo_tpu` alone on that dataset three
times: as the test writes it; with every timestamp of events.txt raised by
one float32 ulp of its value in seconds (at most 0.48 us over the 6 s,
below the readers' rounding to whole microseconds, so this run can only
show that `evo_tpu` reproduces itself); and with every timestamp raised by
1 us, the least change the format carries (in the tracker's float32
seconds, 2 to 8 ulps; it also moves the events within 1 us of a frame into
the next window). If `evo_tpu` moves as far from itself as the port is
from it, the gap is noise amplified by the tracker, not a fault of the
port. It prints the rows and their differences. It imports JAX: run it on
the CPU, where it takes a few minutes.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    # the device count the test runs under (tests/conftest.py)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from evo_tpu.io import davis as jdavis  # noqa: E402
from evo_tpu.run import quality as jquality  # noqa: E402
from evo_tpu.run.evaluator import Evaluator as JEvaluator  # noqa: E402
from evo_tpu.run.evaluator import EvaluatorParams as JParams  # noqa: E402
from evo_tpu_torch.io import sim  # noqa: E402
from evo_tpu_torch.run import quality  # noqa: E402


def nudge_timestamps(ds_dir: str, how: str) -> int:
    """Raise every event timestamp of ds_dir/events.txt by one float32 ulp
    of its value in seconds (`how="ulp"`) or by 1 us (`how="us"`); returns
    how many integer microseconds moved (the readers round the seconds to
    microseconds)."""
    path = os.path.join(ds_dir, "events.txt")
    data = np.loadtxt(path, dtype=np.float64, ndmin=2)
    t = data[:, 0]
    if how == "ulp":
        new = t + np.spacing(np.abs(t).astype(np.float32)).astype(np.float64)
    else:
        new = t + 1e-6
    before = (t * 1e6 + 0.5).astype(np.int64)
    after = (new * 1e6 + 0.5).astype(np.int64)
    data[:, 0] = new
    np.savetxt(path, data, fmt=("%.9f", "%d", "%d", "%d"))
    return int((before != after).sum())


def score_jax(ds_dir: str, out_dir: str) -> dict:
    jds = jdavis.Davis240cDataset(ds_dir)
    jev = JEvaluator(jds, JParams(output_dir=out_dir, run_compensation=False,
                                  tracker_experiment=True))
    jev.run()
    jev.flush_pending()
    q = jquality.evaluate_tracker(jev.tracker.trajectories, jds.gt_t_us, jds.gt_poses,
                                  jds.calib, plane_depth=2.0, scene="plane")
    return dict(tracker_err_px=float(q.mean_distance_error_px),
                feature_age_s=float(q.mean_feature_age_s), num_tracks=int(q.num_tracks))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0] if argv else tempfile.mkdtemp(prefix="shapes_ulp_")
    cfg = quality.suite_configs()["shapes"]
    out = sim.EventCameraSimulator(sim.SimParams(
        duration_s=cfg["duration_s"], fps=20.0, seed=1, scene="shapes",
        texture_cells=cfg["texture_cells"]), device="cpu").generate()
    ds = sim.write_dataset(os.path.join(root, "ds"), out)
    as_written = score_jax(ds, os.path.join(root, "jax"))
    print("evo_tpu, as written:", json.dumps(as_written), flush=True)
    for how, what in (("ulp", "1 float32 ulp"), ("us", "1 us")):
        nudged_ds = os.path.join(root, f"ds_{how}")
        shutil.copytree(ds, nudged_ds)
        moved = nudge_timestamps(nudged_ds, how)
        nudged = score_jax(nudged_ds, os.path.join(root, f"jax_{how}"))
        print(f"evo_tpu, timestamps + {what} ({moved} of {len(out['events']['t_us'])} "
              "events moved by 1 us):", json.dumps(nudged), flush=True)
        print("difference:", json.dumps({k: nudged[k] - as_written[k] for k in as_written}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
