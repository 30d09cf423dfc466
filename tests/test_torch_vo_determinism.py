"""The BA's normal equations summed in one order on every device
(`solve.precision.SegmentSum` under `vo.ba.observation_sums`), on the CPU.

`index_add_` on the card adds with atomics in the order its threads arrive,
so VO's float32 sums, and with them its poses, changed from run to run
(ROADMAP §C item 5). The fixed-order sums:

- equal `index_add_` bit for bit where the rows come in the front end's
  order (by landmark, then frame): the CPU's arithmetic is unchanged; the
  masked rows (the front end's padding, weight 0) are left out;
- do not change, bit for bit, when the rows are permuted: the order is a
  function of the (slot, landmark, frame) keys alone;
- give `evo_tpu`'s normal equations (its one-device
  `dist.reduce.sharded_normal_equations`, the BA's assembly) within float32
  rounding of the residuals. An observation's residual is the difference of
  two pixel coordinates of 100-200 px and carries their ulp, 1.5e-5 px,
  which the two packages round apart (the port's projection Jacobian is
  closed-form, `evo_tpu`'s `jacfwd`): near the Huber threshold of 0.8 px
  that is 2e-5 of the residual and of its weight, so every block entry is
  held to 5e-5 relative (and 1e-6 of its block's largest entry where
  products cancel), and an entry of bp or bl, Σ_o w_o J_oᵀ r_o over
  residuals of either sign, also to 3e-5 px (two ulps) times Σ_o w_o |J_o|;
- and the compensated (two-float) assembly sums each chunk in order too.

The card's side is `tests/test_torch_gpu.py::test_vo_on_card_repeats_itself`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu.dist import mesh as jmesh
from evo_tpu.dist import reduce as jreduce
from evo_tpu_torch.core import camera, lie
from evo_tpu_torch.solve import precision
from evo_tpu_torch.solve.lm import huber_weights
from evo_tpu_torch.vo import ba

torch.set_num_threads(1)

F, L = 21, 192
INTR = np.array([199.0, 198.0, 132.0, 110.0, -0.37, 0.2, 1e-3, -6e-4, -0.05], np.float32)
BLOCKS = {"frame": [(6, 6), (6,), (1,)], "lm": [(3, 3), (3,), (1,)], "pair": [(6, 3)]}


def _front_end_rows(rng, n_lm=L, n_frames=F):
    """Observation indices as the front end lists them: landmark by
    landmark, each one's frames in time order."""
    of, ol = [], []
    for lm in range(n_lm):
        k = int(rng.integers(2, 12))
        for f in np.sort(rng.choice(n_frames, size=k, replace=False)):
            of.append(int(f))
            ol.append(lm)
    return np.array(of), np.array(ol)


def _values(rng, n, shape):
    scale = 10.0 ** rng.uniform(-3, 3, (n,) + (1,) * len(shape))
    return torch.tensor((rng.standard_normal((n,) + shape) * scale).astype(np.float32))


@pytest.mark.parametrize("slot,shape", [(s, d) for s, shapes in BLOCKS.items()
                                        for d in shapes])
def test_segment_sums_equal_index_add_in_the_front_ends_order(rng, slot, shape):
    of, ol = (torch.tensor(a) for a in _front_end_rows(rng))
    sums = dict(zip(("frame", "lm", "pair"), ba.observation_sums(of, ol, F, L)))
    idx, n = {"frame": (of, F), "lm": (ol, L), "pair": (ol * F + of, L * F)}[slot]
    vals = _values(rng, len(of), shape)
    want = torch.zeros((n,) + shape).index_add_(0, idx, vals)
    got = sums[slot](vals)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


def test_masked_observations_are_left_out(rng):
    """The front end's padding (mask False, weight 0) adds nothing: the sums
    equal `index_add_` over the kept rows alone, bit for bit."""
    of, ol = _front_end_rows(rng)
    pad = 300
    of_p, ol_p = np.r_[of, np.zeros(pad, int)], np.r_[ol, np.zeros(pad, int)]
    mask = np.arange(len(of_p)) < len(of)
    sums = ba.observation_sums(torch.tensor(of_p), torch.tensor(ol_p), F, L,
                               obs_mask=torch.tensor(mask))
    for s, idx, n, shape in zip(sums, (of, ol, ol * F + of), (F, L, L * F),
                                ((6, 6), (3, 3), (6, 3))):
        vals = _values(rng, len(of_p), shape)
        want = torch.zeros((n,) + shape).index_add_(0, torch.tensor(idx), vals[:len(of)])
        assert torch.equal(s(vals), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_observation_sums_do_not_depend_on_the_order_of_the_rows(seed):
    rng = np.random.default_rng(seed)
    of, ol = _front_end_rows(rng)
    perm = rng.permutation(len(of))
    base = ba.observation_sums(torch.tensor(of), torch.tensor(ol), F, L)
    permuted = ba.observation_sums(torch.tensor(of[perm]), torch.tensor(ol[perm]), F, L)
    for s, p, shape in zip(base, permuted, ((6, 6), (3, 3), (6, 3))):
        vals = _values(rng, len(of), shape)
        assert torch.equal(s(vals), p(vals[perm]))


def _ba_problem(rng):
    """A window of F frames on an arc looking at L landmarks, the observations
    that project into the image in the front end's order, 1 px of noise,
    padded to a multiple of 8 as the front end pads."""
    xi = np.zeros((F, 6), np.float32)
    xi[:, 0] = 0.05 * np.arange(F)
    xi[:, 4] = 0.01 * np.arange(F)
    poses = lie.se3_exp(torch.tensor(xi))
    pts = torch.tensor(np.stack([rng.uniform(-2, 3, L), rng.uniform(-1.5, 1.5, L),
                                 rng.uniform(4, 9, L)], -1).astype(np.float32))
    of, ol, op = [], [], []
    for lm in range(L):
        for f in range(F):
            p_c = lie.se3_apply(lie.se3_inverse(poses[f]), pts[lm])
            px = camera.project(torch.tensor(INTR), p_c)
            if p_c[2] > 0.5 and 5 < px[0] < 235 and 5 < px[1] < 175 and rng.random() < 0.4:
                of.append(f)
                ol.append(lm)
                op.append(px.numpy() + rng.normal(0, 1.0, 2))
    pad = -len(of) % 8
    mask = np.r_[np.ones(len(of), bool), np.zeros(pad, bool)]
    of, ol = np.r_[of, np.zeros(pad, int)], np.r_[ol, np.zeros(pad, int)]
    op = np.concatenate([np.array(op, np.float32), np.zeros((pad, 2), np.float32)])
    fixed = np.zeros(F, bool)
    fixed[:2] = True
    return poses.numpy(), pts.numpy(), of.astype(np.int32), ol.astype(np.int32), op, mask, fixed


def test_normal_equations_match_jax(rng):
    poses, pts, of, ol, op, mask, fixed = _ba_problem(rng)
    t = torch.tensor
    got = ba.normal_equations(
        t(poses), t(pts), t(INTR), t(of).long(), t(ol).long(), t(op),
        t(mask).float(), t(fixed), ba.observation_sums(t(of), t(ol), F, L, obs_mask=t(mask)))
    mesh1 = jmesh.make_mesh(n_space=1, n_batch=1, devices=jax.devices()[:1])
    want = jreduce.sharded_normal_equations(
        mesh1, jnp.asarray(poses), jnp.asarray(pts), jnp.asarray(INTR), jnp.asarray(of),
        jnp.asarray(ol), jnp.asarray(op), jnp.asarray(mask), jnp.asarray(fixed))
    # Σ_o w_o |J_o| by slot, in float64: what two ulps of every residual move
    # the gradient blocks bp and bl by
    r, Jp, Jl = ba._obs_linearize(t(poses)[of], t(pts)[ol], t(INTR), t(op))
    wt = (huber_weights((r * r).sum(-1), ba.HUBER) * t(mask)).double()
    Jp = torch.where(t(fixed)[of][:, None, None], torch.zeros_like(Jp), Jp)
    spread = dict(
        bp=torch.zeros(F, 6, dtype=torch.float64).index_add_(
            0, t(of).long(), (wt[:, None, None] * Jp.abs()).sum(1)).numpy(),
        bl=torch.zeros(L, 3, dtype=torch.float64).index_add_(
            0, t(ol).long(), (wt[:, None, None] * Jl.abs()).sum(1)).numpy())
    for name, g, w in zip(("Hpp", "Hll", "A", "bp", "bl"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        tol = 5e-5 * np.abs(w) + 1e-6 * np.abs(w).max() + 3e-5 * spread.get(name, 0.0)
        assert (np.abs(g.numpy() - w) <= tol).all(), (name, np.abs(g.numpy() - w).max())


def test_compensated_scatter_add_sums_each_chunk_in_order(rng):
    """Each chunk's partial sums its rows one after another, as a loop
    would; the partials are then combined by the compensated sum."""
    of, _ = _front_end_rows(rng)
    vals = _values(rng, len(of), (6, 6))
    n_chunks = 32
    c = -(-len(of) // n_chunks)
    parts = torch.zeros((n_chunks, F, 6, 6))
    for i, f in enumerate(of.tolist()):
        parts[i // c, f] += vals[i]
    want = precision.fold(*precision.compensated_reduce(parts, axis=0))
    got = precision.compensated_scatter_add(torch.tensor(of), vals, F, n_chunks=n_chunks)
    assert torch.equal(got, want)
