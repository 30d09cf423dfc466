"""The tracker's alignment step (`evo_tpu_torch.tracker.align.solve_step`)
on the CPU, where it takes its plain version, against the JAX package; and
what the card's kernel (`kernels/align_step.py`, `csrc/align_step.cu`) must
keep, checked without a card.

Tolerances, each with its reason (float32 sampling, reductions over the
625 rect pixels and 4x4 solves in another order than XLA's; the LM carries
that noise along flat directions of the cost):
- ran, lost, alive, counter, n_costs, cur_t, last_update_t identical, the
  event budget within 1 (a truncation to int32);
- the final cost of the rows that ran within 1e-4 relative;
- the centre, and where the warp puts every rect pixel, within 1e-3 px
  (the rows agree to 1e-4 px). The warp's translation is held through the
  pixels it moves and not entry by entry: it carries the rotation times
  the distance to the image origin (~200 px), so 1e-6 rad of rotation is
  2e-4 of translation that moves no pixel;
- the flow angle within 1e-4 rad, taken modulo 2π (0 and 2π - 1e-7 are one
  angle);
- the `leaves_image` row, whose rect warps mostly out of the image, within
  5e-3 px and 3e-3 rad: few pixels hold it, and the plain version alone
  moves it up to 3.4e-3 px and 1.35e-3 rad between the CPU and the card
  (`torch_align_tables.WEAK_ROWS`);
- time_without_update (1 / the centre's move) within 1e-3 relative.
"""

import ctypes
import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu.tracker import align as jalign
from evo_tpu.tracker import patch_state as jps
from evo_tpu_torch.dist import multihost
from evo_tpu_torch.kernels import align_step as kalign
from evo_tpu_torch.tracker import align as talign
from evo_tpu_torch.tracker import patch_state as tps
import torch_align_tables as tables

torch.set_num_threads(1)


def test_solve_step_on_cpu_matches_jax():
    """(a) The step on the CPU against `evo_tpu`'s `optimize_ready_patches`
    followed by `update_budgets_solved`, on one table of ordinary ready rows
    and the edge rows of `torch_align_tables.edge_table` (unready, dead and
    uninitialised rows, border-lost and rect_oob rows among them)."""
    rng = np.random.default_rng(5)
    grads = tables.smooth_grads(rng)
    fields, rows = tables.edge_table(rng, grads)
    latest = grads[1]

    jt, info = jalign.optimize_ready_patches(
        jps.PatchTable(**{k: jnp.asarray(v) for k, v in fields.items()}), jnp.asarray(grads))
    jt = jalign.update_budgets_solved(jt, jnp.asarray(latest), info["ran"])
    ref = {f.name: np.asarray(getattr(jt, f.name)) for f in dataclasses.fields(jt)}

    table, ran, cost, lost = talign.solve_step(
        tps.table_from_numpy(fields, device="cpu"), torch.as_tensor(grads),
        torch.as_tensor(latest))
    ours = tps.table_to_numpy(table)
    ran, cost = ran.numpy(), cost.numpy()

    np.testing.assert_array_equal(ran, np.asarray(info["ran"]))
    np.testing.assert_array_equal(lost.numpy(), np.asarray(info["lost"]))
    # every kind of row is there and did what its name says
    assert ran.sum() == tables.ORDINARY + len(tables.EDGES) - 3
    assert not ran[[rows[k] for k in ("not_ready", "dead", "uninitialized")]].any()
    assert lost.numpy()[rows["lost"]] and not ours["alive"][rows["lost"]]
    assert not ours["alive"][rows["border"]]
    assert ours["num_of_events"][rows["rect_oob"]] == tps.INIT_NUM_EVENTS
    assert (cost[~ran] == 0).all()
    tables.assert_same_step(ours, ref, ran, cost, np.asarray(info["cost"]),
                            fields["center"], rows)
    for name in ("track_id", "init_pt", "ev_t", "ev_count", "grad_slot", "initialized"):
        np.testing.assert_array_equal(ours[name], fields[name], err_msg=name)


def _ready_scan(p: int, rows=slice(None)):
    """process_window_scan on the CPU over rows `rows` of a p-row ready table
    (two sub-batches of 2048 events, as `block_split_check` on the card)."""
    t = multihost._ready_table(np.random.default_rng(1), p, 180, 240)
    ex, ey, et, ep, mask, grads = multihost._scan_inputs(np.random.default_rng(2), 2, 2048,
                                                         180, 240)
    ev = [torch.as_tensor(a) for a in (ex, ey, et, ep, mask)]
    g = torch.as_tensor(grads)
    table = tps.table_from_numpy({k: v[rows] for k, v in t.items()}, device="cpu")
    return talign.process_window_scan(table, g, *ev, g[0])


def test_window_scan_rows_do_not_depend_on_the_block():
    """(b) The plain scan of 128 ready rows against the same rows as two
    blocks of 64, as two ranks of a mesh hold them: bit for bit. The card's
    kernel must give the same property (`test_torch_gpu.py`)."""
    full, log = _ready_scan(128)
    halves = [_ready_scan(128, s) for s in (slice(0, 64), slice(64, 128))]
    assert log["ran"][0].all()  # every row solves in the first sub-batch
    for name in tps.FIELDS:
        joined = torch.cat([getattr(h[0], name) for h in halves])
        assert torch.equal(joined, getattr(full, name)), name
    for name, v in log.items():
        assert torch.equal(torch.cat([h[1][name] for h in halves], 1), v), name


def test_solve_step_on_cpu_takes_the_plain_version(monkeypatch):
    """(c) A table on the CPU goes to `solve_step_ref`, never to the kernel's
    entry, and gives what `solve_step_ref` gives."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's entry was called for a CPU table")

    monkeypatch.setattr(kalign, "align_step", refuse)
    kalign.reset_counts()
    rng = np.random.default_rng(3)
    grads = torch.as_tensor(tables.smooth_grads(rng))
    t = tps.table_from_numpy(tables.edge_table(rng, grads.numpy())[0], "cpu")
    got = talign.solve_step(t, grads, grads[0])
    want = talign.solve_step_ref(t, grads, grads[0])
    for name in tps.FIELDS:
        assert torch.equal(getattr(got[0], name), getattr(want[0], name)), name
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    assert kalign.launches_align == 0


def test_kernel_entry_refuses_cpu_tensors():
    """(c) The kernel's entry raises on CPU tensors, naming the plain
    version, before it builds or launches anything."""
    t = tps.empty_table(4, device="cpu")
    g = torch.zeros(2, 2, 180, 240)
    kalign.reset_counts()
    with pytest.raises(RuntimeError, match="no kernel for device cpu.*solve_step_ref"):
        kalign.align_step(t, g, g[0])
    assert kalign.launches_align == 0 and not kalign._libs


def _c_declaration():
    path = os.path.join(os.path.dirname(kalign.__file__), "..", "csrc", "align_step.cu")
    with open(path) as f:
        src = f.read()
    return src


def test_signature_table_matches_the_c_declaration():
    """(d) The ctypes argument types of `evo_align_step` are those of its
    `extern "C"` declaration in csrc/align_step.cu, argument by argument:
    the address of the pointer array, then an int for each int and a
    pointer for the stream. The array is the kernel's `Args` pointers: the
    wrapper's `POINTERS` name them in the struct's order (the table's fields
    in `IN_FIELDS` order, the gradients, the outputs as `<field>_out`), and
    the source counts as many (`kPointers`)."""
    src = _c_declaration()
    m = re.search(r'extern "C" int (\w+)\((.*?)\)\s*\{', src, re.S)
    assert m is not None
    name, params = m.group(1), [p.strip() for p in m.group(2).split(",")]
    argtypes, restype = kalign._SIGNATURES[name]
    assert restype is kalign._I and len(argtypes) == len(params), (len(argtypes), len(params))
    assert params[0].startswith("const void* const*") and argtypes[0] is kalign._P
    for ctype, decl in zip(argtypes[1:], params[1:]):
        want = kalign._P if "*" in decl else kalign._I
        assert decl.split()[0].rstrip("*") in ("int", "void"), decl
        assert ctype is want, decl
    # the pointer members of `struct Args`, in order
    body = re.search(r"struct Args \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    pointers, ints = [], []
    for stmt in filter(None, (t.strip() for t in body.split(";"))):
        for k, piece in enumerate(stmt.split(",")):
            ident = re.findall(r"\w+", piece)[-1]
            (pointers if "*" in piece else ints).append(ident)
    assert pointers == kalign.POINTERS
    assert ints == ["P", "E", "S", "H", "W"]
    n = re.search(r"constexpr int kPointers = (\d+);", src)
    assert n is not None and int(n.group(1)) == len(kalign.POINTERS)
    fields_in = [n for n, _ in kalign.IN_FIELDS]
    assert pointers[:len(fields_in)] == fields_in
    outs = pointers[len(fields_in) + 2:len(fields_in) + 2 + len(kalign.OUT_FIELDS)]
    assert outs == [f + "_out" for f in kalign.OUT_FIELDS]


@pytest.mark.parametrize("extras", [(), ("integrated", "trips"),
                                    ("integrated", "trips", "clocks")])
def test_wrapper_outputs_are_one_arena_in_pointer_order(extras):
    """(e) A call's outputs (`kernels.align_step._run`, with a launch that
    only records what it is given, on CPU tensors): every output a
    contiguous tensor of its field's dtype and shape, views of one arena
    that do not overlap; the pointer array the table's inputs in
    `IN_FIELDS` order, the gradients, then each output's own address in
    `POINTERS` order (0 where it is not made); the int64 clocks 8-byte
    aligned; P, E, S, H, W as the table and the gradients give them."""
    t = multihost._ready_table(np.random.default_rng(1), 12, 180, 240)
    table = tps.table_from_numpy(t, device="cpu")
    g = torch.zeros(3, 2, 180, 240)
    seen = {}

    def launch(fn, address, *args):
        seen["ptrs"] = list((ctypes.c_uint64 * len(kalign.POINTERS)).from_address(address))
        seen["args"] = args

    ins = [getattr(table, n) for n in kalign._IN_NAMES]
    outs = kalign._run(None, table, ins, g, g[0], extras, launch)
    assert seen["args"] == (12, table.ev_t.shape[1], 3, 180, 240)
    n_in = len(kalign.IN_FIELDS)
    assert seen["ptrs"][:n_in] == [x.data_ptr() for x in ins]
    assert seen["ptrs"][n_in:n_in + 2] == [g.data_ptr(), g[0].data_ptr()]
    want = {n: (getattr(table, n).dtype, getattr(table, n).shape) for n in kalign.OUT_FIELDS}
    want.update(ran=(torch.bool, (12,)), lost=(torch.bool, (12,)), cost=(torch.float32, (12,)),
                integrated=(torch.float32, (12, 25, 25)), trips=(torch.int32, (12,)),
                clocks=(torch.int64, (12, len(kalign.STAGES))))
    spans = []
    for name, ptr in zip(kalign.POINTERS[n_in + 2:], seen["ptrs"][n_in + 2:]):
        field = name[:-len("_out")]
        if field in kalign.EXTRA_OUTPUTS and field not in extras:
            assert ptr == 0 and field not in outs, field
            continue
        out = outs[field]
        assert (out.dtype, out.shape) == want[field], field
        assert out.is_contiguous() and out.data_ptr() == ptr, field
        spans.append((ptr, ptr + out.numel() * out.element_size()))
    assert set(outs) == set(kalign.OUT_FIELDS + kalign.LOG_OUTPUTS) | set(extras)
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    if "clocks" in extras:
        assert outs["clocks"].data_ptr() % 8 == 0


@pytest.mark.parametrize("cname, value", [
    ("kExtent", tps.PATCH_EXTENT), ("kWin", talign.GRAD_WINDOW),
    ("kReadyCounter", tps.READY_COUNTER), ("kInitEvents", tps.INIT_NUM_EVENTS),
    ("kMinEvents", tps.MIN_NUM_EVENTS), ("kMaxEvents", tps.MAX_NUM_EVENTS),
    ("kMaxIters", talign.MAX_LM_ITERS), ("kHuber", talign.HUBER),
    ("kFtol", talign.ALIGN_FTOL), ("kLostCost", talign.LOST_COST_THRESHOLD),
    ("kMaxStep", tps.PATCH_EXTENT / 2.0), ("kMaxTravel", talign.MAX_SOLVE_TRAVEL),
])
def test_kernel_constants_match_the_plain_version(cname, value):
    """(d) Each constant the kernel holds has the plain version's value."""
    m = re.search(rf"constexpr (?:int|float) {cname} = ([^;]+);", _c_declaration())
    assert m is not None, cname
    assert float(m.group(1).rstrip("f")) == pytest.approx(value, rel=1e-7), cname
