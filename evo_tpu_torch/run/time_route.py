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
`time_splat.Timer`) and the heaviest call in full: host µs a launch (the
least of `HOST_ROUNDS` rounds of 200), the
bound (`time_comp.bound`: the bytes the call must move over 3.35 TB/s
against its operations over 67 TFLOP/s) and the plain version's time. No
PyTorch call computes the routing, so there is no library time. Where the
tree has the clock build (`kernels.route_events.STAGES`, -DEVO_RE_CLOCKS),
`clock_route_events` splits the heaviest call by stage: the slowest
block's cycles, held to the plain build's bits; ptxas's registers of both
builds are printed beside. Any checkout since the routing kernel can be
timed, so the parent and this tree run in turns in one call:

    python evo_tpu_torch/run/time_route.py --root PARENT
    python evo_tpu_torch/run/time_route.py

(PARENT: the other commit unpacked into a directory `.gitignore` lists.)

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
# host µs a launch: the least of this many rounds of REPS launches (the
# host's time spreads with the load of the cores it shares)
HOST_ROUNDS = 5
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


def clock_route_events(timer, call) -> dict:
    """The clock build's split of one recorded call (`kernels.route_events.
    STAGES`): one launch after REPS of them (a cold first launch reads
    slower), held to the plain build's bits. The launch lasts as long as its
    slowest block, so the split is that block's (by its total), beside each
    stage's largest value over the blocks."""
    from evo_tpu_torch.kernels import route_events as kre

    table = call[0]
    clk = torch.zeros((table.capacity, len(kre.STAGES)), dtype=torch.int64,
                      device=table.center.device)
    timer.device_ms(lambda: kre.route_events(*call, clocks=clk), REPS)
    got = kre.route_events(*call, clocks=clk)
    ref = kre.route_events(*call)
    for name in kre.RING + ("ev_count", "counter"):
        if not torch.equal(getattr(got, name), getattr(ref, name)):
            raise AssertionError(f"route_events' clock build gives another {name}")
    c = clk.cpu()
    ran = c[:, -1] > 0
    if not torch.equal(c[:, :-1].sum(1), c[:, -1]) or (c < 0).any() or not ran.any():
        raise AssertionError(f"route_events' clock build's stages are off: {c[:4].tolist()}")
    slow = int(c[:, -1].argmax())
    return dict(block=slow, cycles=dict(zip(kre.STAGES, c[slow].tolist())),
                largest=dict(zip(kre.STAGES, c.amax(0).tolist())), blocks=int(ran.sum()))


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
    clock = clock_route_events(timer, call) if hasattr(kre, "STAGES") else None
    return dict(kernel="route_events",
                shape=f"{table.capacity} rows ({int(table.alive.sum())} live), E "
                f"{table.ev_t.shape[1]}, {ex.shape[0]} events ({int(mask.sum())} valid), "
                f"{hits[best]} routed", compared=len(calls), max_abs_err=0.0,
                digest=digest.hexdigest(), calls_us=calls_us, calls_sum_us=sum(calls_us),
                heaviest_call=best, routed=sum(hits), clock=clock,
                ms=timer.device_ms(lambda: ps.route_events(*call), REPS),
                host_us=min(Timer.host_us(lambda: ps.route_events(*call), REPS)
                            for _ in range(HOST_ROUNDS)),
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
    from evo_tpu_torch.kernels import nvcc
    from evo_tpu_torch.run.time_frames import ptxas

    calls = record_routes(dataset)
    row = check_route_events(Timer(dev), calls)
    row["ptxas"] = {name: ptxas(name) for name in ("evo_route_events", "evo_route_events_clock")
                    if ptxas(name)}
    label = card()
    print(f"time_route {args.root}: kernel " + json.dumps(dict(row, card=label)), flush=True)
    if row["clock"]:
        print(f"time_route {args.root}: clock split of the heaviest call (call "
              f"{row['heaviest_call']}), the slowest block's cycles " + json.dumps(row["clock"])
              + f" ({label})", flush=True)
    for name in ("evo_route_events", "evo_route_events_clock"):
        for line in nvcc.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"time_route {args.root}: ptxas ({name}): {line.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
