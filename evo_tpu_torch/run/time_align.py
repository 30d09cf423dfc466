"""Device and host time of the alignment kernel of one tree, on one CUDA card.

    python evo_tpu_torch/run/time_align.py [--root DIR] [--reps N]

Builds `csrc/align_step.cu` of the `evo_tpu_torch` package found under DIR
(default: the tree this file is in) and times `kernels.align_step.align_step`
on the window scan's ready table (`align_inputs`: 128 ready rows, 320 events
a row, a [4, 2, 180, 240] gradient store), as `chip_smoke.py` phase 3 does,
and on its first 1 and 16 rows (the main path's launches carry fewer ready
rows than 128): device µs a launch over N launches between one pair of CUDA
events, and host µs a wrapper call (the least of `HOST_TRIES` runs of N
calls). Where the tree's wrapper has a clock build (`align_step(...,
clocks=True)`), it also prints each stage's cycles
(`kernels.align_step.STAGES`): the mean over the ready rows and the row
that runs longest, which sets the launch's time. Only names that every
version of the port since the kernel has are used otherwise, so two trees
can be compared in one run on one card: unpack the other commit somewhere
and run this file once per tree, in turns.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROWS = (1, 16, 128)
HOST_TRIES = 5  # host µs: the least of this many runs (the host is shared and noisy)


def align_inputs(dev, rows: int = 128):
    """The first `rows` rows of the 128-row ready table and the 4-slot
    gradient store of the window scan's checks (`block_split_check`,
    `multihost.parity_worker`)."""
    from evo_tpu_torch.dist import multihost
    from evo_tpu_torch.tracker import patch_state as ps

    t = multihost._ready_table(np.random.default_rng(1), 128, 180, 240)
    *_, grads = multihost._scan_inputs(np.random.default_rng(2), 2, 2048, 180, 240)
    return (ps.table_from_numpy({k: v[:rows] for k, v in t.items()}, dev),
            torch.as_tensor(grads).to(dev))


def has_clock(kalign) -> bool:
    """Whether this version of the wrapper has the clock build."""
    return "clocks" in inspect.signature(kalign.align_step).parameters


def sm_clock_mhz() -> tuple[float, float]:
    """(current, largest) SM clock of card 0 in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    cur, top = out.stdout.strip().splitlines()[0].split(",")
    return float(cur), float(top)


def clock_split(kalign, table, g) -> dict:
    """One launch of the clock build: cycles by stage, mean over the ready
    rows and of the longest row, and the LM trips."""
    _, ran, _, _, extra = kalign.align_step(table, g, g[0], trips=True, clocks=True)
    torch.cuda.synchronize()
    clocks = extra["clocks"][ran].double().cpu()
    trips = extra["trips"][ran].cpu()
    longest = int(clocks[:, -1].argmax())
    return dict(stages=list(kalign.STAGES),
                mean_cycles=[round(float(v), 1) for v in clocks.mean(0)],
                longest_row_cycles=[int(v) for v in clocks[longest]],
                longest_row_trips=int(trips[longest]), mean_trips=float(trips.float().mean()))


def split_text(c: dict) -> str:
    """A clock split as one line: each stage's mean | longest-row cycles."""
    return "  ".join(f"{s} {m:.0f} | {x}" for s, m, x in
                     zip(c["stages"], c["mean_cycles"], c["longest_row_cycles"]))


def sweep(kalign, timer, dev, reps: int, rows=ROWS) -> dict:
    """Device and host time (and the clock split, where there is a clock
    build) at each number of ready rows."""
    clocked = has_clock(kalign)
    out = {}
    for n in rows:
        table, g = align_inputs(dev, n)
        _, ran, _, _, extra = kalign.align_step(table, g, g[0], trips=True)
        row = dict(ready_rows=int(ran.sum()), max_trips=int(extra["trips"].max()),
                   device_us=timer.device_ms(lambda: kalign.align_step(table, g, g[0]),
                                             reps) * 1e3,
                   host_us=min(timer.host_us(lambda: kalign.align_step(table, g, g[0]), reps)
                               for _ in range(HOST_TRIES)))
        if clocked:
            row["clock_build_device_us"] = timer.device_ms(
                lambda: kalign.align_step(table, g, g[0], clocks=True), reps) * 1e3
            row["clock"] = clock_split(kalign, table, g)
        out[n] = row
    return out


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here,
                    help="directory that holds the evo_tpu_torch package to time")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_align: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from evo_tpu_torch.kernels import align_step as kalign
    from evo_tpu_torch.run.time_splat import Timer, card

    dev = torch.device("cuda")
    label = card()
    t0 = time.perf_counter()
    kalign._lib()
    if has_clock(kalign):
        kalign._lib(clocks=True)
    print(f"{args.root}: built in {time.perf_counter() - t0:.2f} s", flush=True)
    rows = sweep(kalign, Timer(dev), dev, args.reps)
    for n, row in rows.items():
        print(f"{args.root}: align_step {n} ready rows (max {row['max_trips']} LM trips): "
              f"device {row['device_us']:.2f} us/launch over {args.reps}  wrapper host "
              f"{row['host_us']:.2f} us ({label})", flush=True)
    if has_clock(kalign):
        cur, top = sm_clock_mhz()
        print(f"{args.root}: SM clock {cur:.0f} MHz now, {top:.0f} MHz at most", flush=True)
        for n, row in rows.items():
            c = row["clock"]
            print(f"{args.root}: clock split at {n} rows (cycles; mean over rows | longest "
                  f"row, {c['longest_row_trips']} trips): {split_text(c)}", flush=True)
    print(f"time_align {args.root}: " + json.dumps(dict(card=label, reps=args.reps, rows=rows)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
