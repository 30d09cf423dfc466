"""The event routing kernel of one tree on one CUDA card, on every sub-batch
of a tracker-experiment run, held to its plain version and timed.

    python evo_tpu_torch/run/time_route.py [--root DIR]

Simulates `chip_smoke.py`'s scene (`3walls`, 1.2 s at 20 fps, seed 3) with
the `evo_tpu_torch` package found under DIR (default: the tree this file is
in), runs the tracker experiment on the card with every parameter at its
default and records the arguments of every `patch_state.route_events` call
(`record_routes`: one a sub-batch, before each `align_step` launch). Then
`check_route_events` holds `kernels.route_events` to `route_events_ref` on
each recorded call, bit for bit (rings, `ev_count`, `counter`), hashes the
outputs in order (`digest`), times each call (device µs a launch over 200
launches between one pair of CUDA events behind a busy queue,
`time_splat.Timer`) and the heaviest call in full: host µs a launch, the
bound (`time_comp.bound`: the bytes the call must move over 3.35 TB/s
against its operations over 67 TFLOP/s) and the plain version's time. No
PyTorch call computes the routing, so there is no library time.
`chip_smoke.py` phase 3 runs the same functions.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

import torch

SCENE = dict(duration_s=1.2, fps=20.0, seed=3, scene="3walls", contrast_threshold=0.05)
REPS = 200
# the table's fields the routing reads
FIELDS = ("center", "alive", "ev_count", "counter", "ev_t", "ev_x", "ev_y", "ev_p")


def record_routes(dataset, frames: int | None = None) -> list:
    """The arguments of every `route_events` call of the tracker experiment
    (over its first `frames` frames), each tensor copied: (table, ex, ey,
    et, ep, mask)."""
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams
    from evo_tpu_torch.tracker import patch_state as ps

    calls = []
    inner = ps.route_events

    def recording(table, *events):
        calls.append((table.replace(**{k: getattr(table, k).clone() for k in FIELDS}),
                      *(t.clone() for t in events)))
        return inner(table, *events)

    ps.route_events = recording
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ev = Evaluator(dataset, EvaluatorParams(tracker_experiment=True, output_dir=tmp))
            ev.run(max_frames=frames)
            ev.finish()
    finally:
        ps.route_events = inner
    return calls


def route_work(table, ex, mask) -> tuple:
    """(bytes, operations) that a routing call's data needs: the rings in
    and out (16 bytes a slot each way), the table's 17 bytes a row in and 8
    out, the events (17 bytes each) in; six operations (two differences, two
    magnitudes, two compares) for each live row and valid event."""
    p, e = table.ev_t.shape
    n = ex.shape[0]
    n_bytes = 2 * 16 * p * e + 17 * p + 8 * p + 17 * n
    return n_bytes, 6.0 * int(table.alive.sum()) * int(mask.sum())


def check_route_events(timer, calls: list) -> dict:
    """`route_events` (the kernel) against `route_events_ref` on every
    recorded call, bit for bit, each call timed (`calls_us`, in the run's
    order) and its outputs hashed in order (`digest`); the call with the
    most routed events timed in full."""
    from evo_tpu_torch.kernels import route_events as kre
    from evo_tpu_torch.run.time_comp import bound
    from evo_tpu_torch.run.time_splat import Timer
    from evo_tpu_torch.tracker import patch_state as ps

    digest, calls_us, hits = hashlib.sha256(), [], []
    names = kre.RING + ("ev_count", "counter")
    for k, call in enumerate(calls):
        got, ref = ps.route_events(*call), ps.route_events_ref(*call)
        for name in names:
            a, b = getattr(got, name), getattr(ref, name)
            if a.dtype != b.dtype or a.cpu().numpy().tobytes() != b.cpu().numpy().tobytes():
                raise AssertionError(f"route_events differs from its plain version at call "
                                     f"{k} in {name}")
            digest.update(a.cpu().numpy().tobytes())
        hits.append(int((got.ev_count - call[0].ev_count).sum()))
        calls_us.append(1e3 * timer.device_ms(lambda: ps.route_events(*call), REPS))
    best = max(range(len(calls)), key=lambda k: (hits[k], k))
    call = calls[best]
    table, ex, mask = call[0], call[1], call[5]
    b_ms, by = bound(*route_work(table, ex, mask))
    return dict(kernel="route_events",
                shape=f"{table.capacity} rows ({int(table.alive.sum())} live), E "
                f"{table.ev_t.shape[1]}, {ex.shape[0]} events ({int(mask.sum())} valid), "
                f"{hits[best]} routed", compared=len(calls), max_abs_err=0.0,
                digest=digest.hexdigest(), calls_us=calls_us, calls_sum_us=sum(calls_us),
                routed=sum(hits), ms=timer.device_ms(lambda: ps.route_events(*call), REPS),
                host_us=Timer.host_us(lambda: ps.route_events(*call), REPS),
                plain_ms=timer.device_ms(lambda: ps.route_events_ref(*call), 20),
                bound_ms=b_ms, bound_by=by, library_ms=None)


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here,
                    help="directory that holds the evo_tpu_torch package to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_route: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from evo_tpu_torch.io import sim
    from evo_tpu_torch.run.time_splat import Timer, card

    dev = torch.device("cuda")
    dataset = sim.to_dataset(sim.EventCameraSimulator(sim.SimParams(**SCENE),
                                                      device=dev).generate())
    row = check_route_events(Timer(dev), record_routes(dataset))
    print(f"time_route {args.root}: kernel " + json.dumps(dict(row, card=card())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
