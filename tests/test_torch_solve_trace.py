"""The tracker's alignment solve in `evo_tpu` and in the port, solve by solve,
on a 0.3 s prefix of the `shapes` quality row's scene (`torch_solve_trace`,
the helper that records every solve of both packages through run-time
wrappers; ROADMAP §C item 2).

- Both packages solve the same rows of the same sub-batches, with equal
  integer inputs (integration image and set size, budget, gradient slot and
  its frame), up to the first solve whose two results part by more than
  rounding.
- `evo_tpu`'s recorded inputs, replayed through the port's `solve_step_ref`,
  give `evo_tpu`'s outputs to float32 rounding: centre and the warp's rect
  corners within 5e-4 px, flow within 2e-5 rad, cost within 2e-5 relative,
  lost and budget equal. (1e-5 px is less than one float32 ulp of a
  coordinate above 128 px, 1.5e-5 px; the two packages order their sums
  differently, and up to 10 LM trips carry the rounding: 1.2e-4 px at the
  corners at the 99th percentile of the 6 s scene's solves.) The rows that
  part by more, 3e-3 px and more, are LM solves whose stop test
  `cost - cost_new <= ftol * cost` falls within 2 % of its threshold, where
  the packages' costs differ by rounding (a few 1e-6 relative, a few % of a
  late trip's decrease): one package takes one more trip. With the port's threshold moved 2 % one way or the other,
  each such row gives `evo_tpu`'s output to the same rounding bar.
"""

import pytest
import torch

import torch_solve_trace as trace
from torch_run_cache import once_per_run

torch.set_num_threads(1)

STEPS = 4  # the prefix's first sub-batches that solve


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """Both packages' traces of the prefix, made once for the whole run."""
    def compute():
        work = tmp_path_factory.mktemp("solve_trace")
        ds = trace.write_scene(str(work), duration_s=0.3)
        jt, pt = trace.Trace(), trace.Trace()
        trace.run_jax(ds, str(work / "jax"), jt)
        trace.run_port(ds, str(work / "port"), pt)
        return jt, pt

    return once_per_run(tmp_path_factory, "torch_solve_trace", compute)


def _solving_steps(jt):
    return [s for s in jt.steps if len(s["rows"])][:STEPS]


@pytest.mark.parametrize("k", range(STEPS))
def test_evo_tpu_solves_replay_through_the_port(traces, k):
    """Every row of the k-th solving sub-batch: `evo_tpu`'s outputs to
    rounding, or, where its stop test sits at the threshold, with the
    threshold moved by 2 %."""
    jt, _ = traces
    s = _solving_steps(jt)[k]
    got = trace.replay_rows(jt, s)
    assert all(d["ran"] for d in got)
    apart = [i for i, d in enumerate(got) if not trace.within_rounding(d)]
    for i in apart:
        assert trace.at_the_stop(jt, s, i), (s["step"], i, got[i])
    assert len(apart) <= 2, (s["step"], apart)


def test_the_prefix_holds_a_stop_at_its_threshold(traces):
    """The rows that part: at least one in the prefix, each more than 2e-3
    px away at the nominal threshold, a whole LM trip (the test above holds
    each to rounding under a threshold 2 % away)."""
    jt, _ = traces
    found = 0
    for s in _solving_steps(jt):
        for d in trace.replay_rows(jt, s):
            if trace.within_rounding(d):
                continue
            found += 1
            assert max(d["centre"], d["warp"]) > 2e-3, d
    assert found >= 1


def test_both_packages_solve_alike_until_a_stop_parts_them(traces):
    """The same sub-batches and the same solves (track, ordinal); every
    integer input equal, and every float input within 1e-4 px, up to the
    first solve whose outputs part by more than rounding."""
    jt, pt = traces
    assert len(jt.steps) == len(pt.steps)
    js, pts = trace.solves(jt), trace.solves(pt)
    assert set(js) == set(pts)
    first = trace.first_differences(jt, pt)
    parted = first["first_int"]["step"] if "first_int" in first else len(jt.steps)
    for key in sorted(js, key=lambda k: js[k]):
        a, b = trace.row_of(jt, js[key]), trace.row_of(pt, pts[key])
        d = trace.compare_rows(a, b)
        if trace._outputs_apart(d, trace.ROUND_PX):
            assert a["step"] < parted, (key, d)
            break
        assert not d["int_inputs"], (key, d)
        assert not trace._float_inputs_apart(d), (key, d)


def test_a_candidate_nudge_moves_only_its_trip(traces):
    """`CandidateNudge` records the cost of each linearisation of a row's
    solve and changes nothing unless asked; a large nudge of the trip whose
    candidate reached the lowest cost (an accepted trip) moves that cost
    alone, rejects the candidate, and so sends the LM down another path
    from that trip on."""
    jt, _ = traces
    s = _solving_steps(jt)[0]
    plain = trace.replay_rows(jt, s, [0])[0]
    with trace.CandidateNudge() as rec:
        same = trace.replay_rows(jt, s, [0])[0]
    assert same == plain
    costs = [float(c[0]) for c in rec.costs]
    assert len(costs) >= 2 and all(c > 0 for c in costs)
    best = 1 + min(range(len(costs) - 1), key=lambda k: costs[k + 1])
    assert costs[best] < costs[0]
    with trace.CandidateNudge(best, 1.0) as nudged:
        trace.replay_rows(jt, s, [0])
    after = [float(c[0]) for c in nudged.costs]
    assert after[:best] == costs[:best] and after[best] > max(costs[:best])
    assert after[best + 1:] != costs[best + 1:]


def test_a_stop_at_its_threshold_is_a_tie_of_one_trip(traces):
    """Each row of the prefix that parts at its stop test (`at_the_stop`)
    has a trip whose decrease of the cost lies within `TIE` of ftol, and a
    nudge of that trip's candidate cost gives `evo_tpu`'s outputs to
    rounding (`trip_decisions`' `decided_at`)."""
    jt, _ = traces
    found = 0
    for s in _solving_steps(jt):
        for i, d in enumerate(trace.replay_rows(jt, s)):
            if trace.within_rounding(d):
                continue
            found += 1
            got = trace.trip_decisions(jt, s, i)
            assert got["decided_at"] is not None and got["decided_at"][1] == "stop", (
                s["step"], i, got)
            assert got["stop_margin"] <= trace.TIE and got["reached_by"] is not None
    assert found >= 1
