"""The compensation LM's loop (`tracker.compensate.lm_motion_field`) and the
plain version of kernel B's loop entry (`compensate.lm_step_ref`), on the
CPU, held bit for bit to the loop as it was before it was restructured for
the card: that loop is kept here as the oracle (`oracle_lm`). The
restructured loop evaluates the residuals and Jacobians once a trip, at the
candidate, and keeps them on an accept, where the old loop evaluated them
again at the start of the next trip: the same bits, since both are the same
computation on the same velocities. Reading the stop flag every trip or
every fourth trip gives the same bits too: a window that has stopped keeps
its state.

Inputs: the translating-line window of `tests/test_torch_compensate.py` (a
60x80 sensor, 12 tiles of 20 px) and the three windows of
`tests/test_torch_temporal.py`, solved together. The wrappers of kernels A
and B raise on a CPU tensor, a wrong type or a wrong shape before anything
is built."""

import numpy as np
import pytest
import torch

from evo_tpu_torch.dist import temporal
from evo_tpu_torch.kernels import comp_step, comp_tile
from evo_tpu_torch.solve.lm import huber_weights
from evo_tpu_torch.tracker import compensate as tcomp
from tests.test_torch_dist import _moving_lines

torch.set_num_threads(1)

H, W = 60, 80
KW = dict(tile=20, scale=1e-3, tv_weight=1e3, tv_huber=10.0)


def oracle_lm(v, data, *, tile, scale, tv_weight, tv_huber, max_iters, loss, edge_diffs,
              solve):
    """The loop before the restructuring, one host read a trip."""
    nw, T = v.shape[:2]

    def total_cost(v):
        r = tcomp.tile_residual_ref(v.reshape(nw * T, 2), data, tile, scale,
                                    loss).reshape(nw, T)
        return (r * r).sum(-1) + tcomp.tv_rho(edge_diffs(v), tv_weight, tv_huber).sum(-1)

    with torch.no_grad():
        cost = total_cost(v)
        cost0 = cost
        lam = torch.full((nw,), 1e-4, dtype=torch.float32)
        active = torch.ones(nw, dtype=torch.bool)
        for _ in range(max_iters):
            r, J = tcomp.tile_residual_and_jacobian_ref(v.reshape(nw * T, 2), data, tile,
                                                        scale, loss)
            r, J = r.reshape(nw, T), J.reshape(nw, T, 2)
            d = edge_diffs(v)
            w2 = huber_weights(((tv_weight * d.abs()) ** 2).sum(-1), tv_huber) \
                * tv_weight * tv_weight
            delta, ok = solve(J[..., :, None] * J[..., None, :], J * r[..., None], w2, d, lam)
            bad = ~ok | ~torch.isfinite(delta).all(-1).all(-1)
            delta = torch.where(bad[:, None, None], torch.zeros_like(delta), delta)
            v_new = v + delta
            cost_new = total_cost(v_new)
            accept = active & torch.isfinite(cost_new) & (cost_new < cost) & ~bad
            rel = (cost - cost_new) / cost.clamp_min(1e-12)
            done = (accept & (rel < 1e-6)) | (lam > 1e5)
            v = torch.where(accept[:, None, None], v_new, v)
            lam = torch.where(active, torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e6),
                              lam)
            cost = torch.where(accept, cost_new, cost)
            active = active & ~done
            if not bool(active.any()):
                break
    return v, cost, cost0


def line_window():
    """The window of tests/test_torch_compensate.py."""
    rng = np.random.default_rng(7)
    n = 4000
    t_us = np.sort(rng.uniform(0, 100_000, n)).astype(np.int64)
    base_x = rng.choice(np.arange(5, W - 5, 10), n)
    x = np.clip(base_x + 0.05 * 1e3 * t_us * 1e-6 + rng.normal(0, 0.3, n), 0, W - 1)
    y = rng.uniform(0, H - 1, n)
    return x.astype(np.float64), y, t_us


def batch(windows, params):
    """The windows' tile data stacked as `dist.temporal` stacks it, with the
    edges."""
    built = [tcomp.build_tile_data(x, y, t, params, H, W, "cpu") for x, y, t in windows]
    e_max = max(b[0].ex.shape[1] for b in built)
    return temporal._stack([temporal._pad_tile_data(b[0], e_max) for b in built]), built[0][1]


CASES = {
    # (windows, params, loss, warm start)
    "line_window": (lambda: [line_window()],
                    tcomp.CompensateParams(max_iters=25, events_per_tile_cap=512), "edge", False),
    "line_window_variance": (lambda: [line_window()],
                             tcomp.CompensateParams(max_iters=12, events_per_tile_cap=512),
                             "variance", False),
    "three_windows": (lambda: [_moving_lines(np.random.default_rng(0), 3000, i * 40_000,
                                             30_000, H, W, 0.06, -0.04) for i in range(3)],
                      tcomp.CompensateParams(tile=20, min_events=10, max_iters=40,
                                             events_per_tile_cap=512), "edge", True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    make, p, loss, warm = CASES[request.param]
    data, edges = batch(make(), p)
    nw, T = data.ex.shape[:2]
    v0 = torch.zeros((nw, T, 2))
    if warm:
        v0 = torch.as_tensor(np.random.default_rng(3).normal(0.03, 0.02, (nw, T, 2)),
                             dtype=torch.float32)
    return dict(data=data, edges=edges, p=p, loss=loss, v0=v0, name=request.param)


def run_new(case, monkeypatch, reads_every):
    """The loop with a read of the stop flag every `reads_every` trips: its
    final state and the number of reads."""
    data, edges, p = case["data"], case["edges"], case["p"]
    nw, T = data.ex.shape[:2]
    flat = data.map(lambda a: a.reshape((nw * T,) + a.shape[2:]))
    monkeypatch.setattr(tcomp, "READS_EVERY", reads_every)
    tcomp.reset_counts()
    st = tcomp.lm_motion_field(
        case["v0"], flat, **KW, max_iters=p.max_iters, loss=case["loss"],
        edge_diffs=lambda v: v[:, edges.p] - v[:, edges.q], solve=tcomp.tile_system(nw, edges))
    return st, tcomp.host_reads


def test_restructured_loop_gives_the_old_loops_bits(case, monkeypatch):
    data, edges, p = case["data"], case["edges"], case["p"]
    nw, T = data.ex.shape[:2]
    flat = data.map(lambda a: a.reshape((nw * T,) + a.shape[2:]))
    pe, qe = edges.p, edges.q
    want = oracle_lm(case["v0"], flat, **KW, max_iters=p.max_iters, loss=case["loss"],
                     edge_diffs=lambda v: v[:, pe] - v[:, qe],
                     solve=tcomp.tile_system_ref(nw, T, pe, qe))
    st, reads = run_new(case, monkeypatch, 1)
    for a, b in zip((st.v, st.cost, st.cost0), want):
        assert torch.equal(a, b)
    assert float(st.cost.max()) < float(st.cost0.max()) \
        or case["name"] == "line_window_variance"
    assert (st.iters >= 1).all() and reads >= 1


def test_reads_every_fourth_trip_give_the_same_bits(case, monkeypatch):
    one, reads_one = run_new(case, monkeypatch, 1)
    four, reads_four = run_new(case, monkeypatch, 4)
    for name in ("v", "cost", "cost0", "iters"):
        assert torch.equal(getattr(one, name), getattr(four, name))
    assert reads_four <= -(-reads_one // 4) + 1


def test_kernel_b_plain_step_composes_to_the_loop(case, monkeypatch):
    """`lm_step_ref` launched as the card's loop launches kernel B (INIT |
    HEAD, then TAIL | HEAD each trip, the last TAIL alone), with the plain
    residuals at each candidate, gives the loop's bits."""
    data, edges, p = case["data"], case["edges"], case["p"]
    nw, T = data.ex.shape[:2]
    flat = data.map(lambda a: a.reshape((nw * T,) + a.shape[2:]))
    pe, qe = edges.p, edges.q
    tv = dict(tv_weight=KW["tv_weight"], tv_huber=KW["tv_huber"])

    def residuals(v):
        r, J = tcomp.tile_residual_and_jacobian_ref(v.reshape(nw * T, 2), flat, KW["tile"],
                                                    KW["scale"], case["loss"])
        return r.reshape(nw, T), J.reshape(nw, T, 2)

    r, J = residuals(case["v0"])
    st = tcomp.LmState(v=case["v0"], r=r, J=J, d=None, lam=torch.full((nw,), 1e-4),
                       cost=None, cost0=None, active=torch.ones(nw, dtype=torch.bool),
                       iters=torch.zeros(nw, dtype=torch.int32))
    tcomp.lm_step_ref(st, comp_step.INIT | comp_step.HEAD, pe, qe, **tv)
    for k in range(p.max_iters):
        r_new, J_new = residuals(st.v_new)
        last = k + 1 == p.max_iters
        tcomp.lm_step_ref(st, comp_step.TAIL | (0 if last else comp_step.HEAD), pe, qe,
                          r_new=r_new, J_new=J_new, **tv)
    want, _ = run_new(case, monkeypatch, 1)
    for name in ("v", "cost", "cost0", "iters"):
        assert torch.equal(getattr(st, name), getattr(want, name))


def test_solve_motion_field_is_the_loop_of_one_window():
    x, y, t = line_window()
    p = tcomp.CompensateParams(max_iters=25, events_per_tile_cap=512)
    data, edges, *_ = tcomp.build_tile_data(x, y, t, p, H, W, "cpu")
    v, cost, cost0 = tcomp.solve_motion_field(data, edges, **KW, max_iters=25)
    want = oracle_lm(torch.zeros((1, 12, 2)), data, **KW, max_iters=25, loss="edge",
                     edge_diffs=lambda v: v[:, edges.p] - v[:, edges.q],
                     solve=tcomp.tile_system_ref(1, 12, edges.p, edges.q))
    for a, b in zip((v, cost, cost0), want):
        assert torch.equal(a, b[0])


def _tile_args(rows=4, e=8, **change):
    t = dict(vel=torch.zeros(rows, 2), ex=torch.zeros(rows, e), ey=torch.zeros(rows, e),
             dt_us=torch.zeros(rows, e), valid=torch.zeros(rows, e, dtype=torch.bool),
             tlx=torch.zeros(rows), tly=torch.zeros(rows),
             active=torch.ones(rows, dtype=torch.bool), r=torch.empty(rows),
             J=torch.empty(rows, 2))
    t.update(change)
    events = {k: t[k] for k in ("ex", "ey", "dt_us", "valid", "tlx", "tly", "active")}
    return t["vel"], events, dict(r=t["r"], J=t["J"])


@pytest.mark.parametrize("change, error", [
    ({}, RuntimeError),
    ({"ex": torch.zeros(4, 8, dtype=torch.float64)}, TypeError),
    ({"valid": torch.zeros(4, 8)}, TypeError),
    ({"vel": torch.zeros(4, 3)}, ValueError),
    ({"tlx": torch.zeros(5)}, ValueError),
    ({"r": torch.empty(3)}, ValueError),
])
def test_comp_tile_checks_before_it_builds(change, error, monkeypatch):
    monkeypatch.setattr(comp_tile, "_lib", lambda *a: pytest.fail("built"))
    vel, events, out = _tile_args(**change)
    with pytest.raises(error):
        comp_tile.TileLaunch(vel, events, tile=20, scale=1e-3, loss="edge", weight=0.16,
                             sigma=1.0, radius=3.0, blur=tcomp.blur_taps(), **out)
    with pytest.raises(ValueError):  # a tile the kernel does not hold: 123 px padded
        comp_tile.TileLaunch(*_tile_args()[:2], tile=41, scale=1e-3, loss="edge", weight=0.16,
                             sigma=1.0, radius=3.0, blur=tcomp.blur_taps(), **out)


def _edges(p, q, t=6):
    return comp_step.Edges(np.asarray(p), np.asarray(q), t, "cpu")


@pytest.mark.parametrize("change, error", [
    ({}, RuntimeError),
    ({"lam": torch.ones(2, dtype=torch.float64)}, TypeError),
    ({"jj": torch.zeros(2, 6, 2)}, ValueError),
    ({"edges": _edges([0] * 7, [1] * 7, t=5)}, ValueError),  # edges of another grid
    ({"jj": torch.zeros(2, 40, 2, 2), "jr": torch.zeros(2, 40, 2),  # band 78: over 64
      "edges": _edges([0] * 7, [39] * 7, t=40)}, ValueError),
])
def test_comp_step_checks_before_it_builds(change, error, monkeypatch):
    monkeypatch.setattr(comp_step, "_lib", lambda *a: pytest.fail("built"))
    a = dict(jj=torch.zeros(2, 6, 2, 2), jr=torch.zeros(2, 6, 2), w2=torch.zeros(2, 7),
             d=torch.zeros(2, 7, 2), lam=torch.ones(2), edges=_edges([0] * 7, [1] * 7))
    a.update(change)
    with pytest.raises(error):
        comp_step.solve(**a)
    if not change:
        with pytest.raises(RuntimeError):
            comp_step.LmLoop(2, a["edges"], 1e3, 10.0)


def test_grid_edges_are_built_once_a_grid():
    """Every window of a grid shares one `Edges`; its band is 2 tx, read
    from no tensor."""
    g = tcomp.grid_edges(9, 12, "cpu")
    assert tcomp.grid_edges(9, 12, "cpu") is g and g.band == 24 and g.t == 108
    assert g.p.shape == (12 * 8 + 11 * 9,) and g.inc.shape == (2 * g.p.shape[0],)
