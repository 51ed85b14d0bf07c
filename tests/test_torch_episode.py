"""The port's surrogate episode engine against the reference's.

``repro_torch.core.episode`` / ``run_batch`` against ``repro.core.episode``
/ ``repro.core.run_batch`` on the same graphs, machines and seeded
batches: the padded plan, the batch axes and the noise bit for bit; the
plain scan (what ``device="cpu"`` runs, and what the card's
``episode_scan`` kernel is held to) against the reference's compiled scan,
through its Pallas transfer fold in interpret mode and through its jnp
fold, with every step's task and resource choice and every f32 value of
the emitted schedule exactly equal; the reference's invariance
properties, input order, capacity and ranking-fidelity contracts on the
port. Runs with ``JAX_PLATFORMS=cpu``.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from _episode_cases import (  # noqa: E402
    EVICT_CAP,
    FIGURE_SPECS,
    MIB,
    NOISE,
    PARITY_SPECS,
    SMALL_SPECS,
    SYNTHETIC,
    assorted_spec,
    case_graph,
    cases,
    configs,
    plan_and_batch,
    tile_graph,
)
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.configs.paper_machine import paper_machine as ref_paper_machine  # noqa: E402
from repro.core import cached_graph as ref_cached_graph  # noqa: E402
from repro.core import episode as ref_ep  # noqa: E402
from repro.core import run_batch as ref_run_batch  # noqa: E402
from repro.core import run_simulation as ref_run_simulation  # noqa: E402
from repro.core.dag import DataObject as RefData  # noqa: E402
from repro.core.dag import Mode as RefMode  # noqa: E402
from repro.core.dag import TaskGraph as RefGraph  # noqa: E402
from repro.linalg.cholesky import cholesky_graph as ref_cholesky_graph  # noqa: E402
from repro.linalg.lu import lu_graph as ref_lu_graph  # noqa: E402
from repro.linalg.qr import qr_graph as ref_qr_graph  # noqa: E402
from repro.sched import resolve as ref_resolve  # noqa: E402
from repro.sched.config import SchedConfig  # noqa: E402
from repro_torch.configs.paper_machine import paper_machine  # noqa: E402
from repro_torch.core import BatchResult, run_batch  # noqa: E402
from repro_torch.convert import graph_from_spec  # noqa: E402
from repro_torch.core import episode as ep  # noqa: E402
from repro_torch.kernels import sched_episode as se  # noqa: E402

REF_GRAPHS = {"cholesky": ref_cholesky_graph, "lu": ref_lu_graph, "qr": ref_qr_graph}
REF_CFG = {p: SchedConfig(backend="jax", pallas=p) for p in ("0", "1")}
SCHEDULE = ("tid", "rid", "act", "start", "xfer_t", "fin", "xfer_b", "evict_b")


def ref_graph(graph_key):
    """The reference's graph for a case's graph key."""
    if len(graph_key) == 2:
        kind, nt = graph_key
        return ref_cached_graph(partial(REF_GRAPHS[kind], nt, 256, with_fns=False))
    spec = SYNTHETIC[graph_key[0]]()
    g = RefGraph()
    for t in spec:
        g.add_task(t["kind"], [(RefData(n, int(sz)), RefMode(m)) for n, sz, m in t["accesses"]],
                   flops=float(t["flops"]))
    return g


def assert_plans_equal(ref_plan, plan):
    for f in dataclasses.fields(ref_plan):
        a, b = getattr(ref_plan, f.name), getattr(plan, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert type(a) is type(b) and a == b, f.name


def ref_plan_for(graph_key, items):
    max_mem = max(
        max((r.mem for r in c["machine"].resources if r.is_accelerator), default=-1)
        for c in items
    )
    n_gpus = sum(r.is_accelerator for r in items[0]["machine"].resources)
    return ref_ep.build_plan(ref_graph(graph_key), ref_paper_machine(n_gpus), n_u=max_mem + 2)


# ---------------------------------------------------------------------------
# the host side: plan, batch axes, noise, strategy mapping


@pytest.mark.parametrize("gpus", [2, 8])
@pytest.mark.parametrize("nt", [4, 8])
@pytest.mark.parametrize("kind", ["cholesky", "lu", "qr"])
def test_plan_axes_and_noise_equal_reference(kind, nt, gpus):
    g, rg = tile_graph(kind, nt), ref_graph((kind, nt))
    m, rm = paper_machine(gpus), ref_paper_machine(gpus)
    # the machine's own n_u, and the wider one of a batch that also holds
    # an 8-GPU machine
    for n_u in (None, 10):
        plan, ref_plan = ep.build_plan(g, m, n_u=n_u), ref_ep.build_plan(rg, rm, n_u=n_u)
        assert_plans_equal(ref_plan, plan)
        assert ep.build_plan(g, m, n_u=n_u) is plan  # memoized on the graph
    for a, b in zip(ep.machine_axes(m, plan.n_res), ref_ep.machine_axes(rm, plan.n_res)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for seed, noise in ((1234, NOISE), (7, 0.2), (3, 0.0)):
        a = ep.noise_factors(seed, noise, plan.n, plan.n_pad)
        assert np.array_equal(a, ref_ep.noise_factors(seed, noise, plan.n, plan.n_pad))


@pytest.mark.parametrize("spec", [
    "heft", "ws", "dual", "dada", "dada?alpha=0", "dada?alpha=0.5&use_cp=1",
    "dada?alpha=1", "dada?alpha=0.25&use_cp=yes", "dual?use_cp=true", "dada?use_cp=0",
])
def test_surrogate_params_equal_reference(spec):
    assert ep.surrogate_params(spec) == ref_ep.surrogate_params(spec)


def test_surrogate_params_rejects_unmapped_policies():
    with pytest.raises(ValueError, match="surrogate"):
        ep.surrogate_params("random")


# ---------------------------------------------------------------------------
# the plain scan against the reference's compiled scan


@pytest.fixture(scope="module")
def parity_runs():
    """Each case once through the port (the plain scan, ``device="cpu"``)."""
    out = {}
    for label, graph_key, gpus, specs, seeds, caps, pad_to, extra in cases():
        items = configs(case_graph(graph_key), gpus, specs, seeds, caps)
        plan, batch = plan_and_batch(items)
        got = ep.run_episodes(plan, batch, device="cpu", pad_to=pad_to,
                              extra_steps=extra, emit_schedule=True)
        out[label] = (graph_key, items, plan, batch, pad_to, extra, got)
    return out


@pytest.mark.parametrize("pallas", ["1", "0"], ids=["pallas-interpret", "jnp"])
@pytest.mark.parametrize("label", [c[0] for c in cases()])
def test_plain_scan_equals_reference_exactly(parity_runs, label, pallas):
    """Every step's task and resource choice, every f32 value of the
    schedule, the makespans, bytes and placement counts are exactly the
    reference's (its Pallas fold in interpret mode, or its jnp fold)."""
    graph_key, items, plan, batch, pad_to, extra, got = parity_runs[label]
    ref_plan = ref_plan_for(graph_key, items)
    assert_plans_equal(ref_plan, plan)
    want = ref_ep.run_episodes(ref_plan, batch, config=REF_CFG[pallas], pad_to=pad_to,
                               extra_steps=extra, emit_schedule=True)
    for key in ("makespan", "total_bytes", "n_placed"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["schedule"].keys() == want["schedule"].keys() == set(SCHEDULE)
    for key in SCHEDULE:
        a, b = got["schedule"][key], want["schedule"][key]
        assert a.dtype == b.dtype and a.shape == b.shape == (len(batch), plan.n + extra), key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert (got["n_placed"] == plan.n).all()


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_plain_scan_equals_reference_on_seeded_graphs(seed):
    """Seeded DAGs of assorted sizes, kinds and access modes, on a random
    mix of machines and capacities: the schedule is the reference's."""
    rng = np.random.default_rng(seed)
    spec = assorted_spec(seed, n_tasks=int(rng.integers(30, 120)), n_data=int(rng.integers(6, 20)))
    g = graph_from_spec(spec)
    ref_g = RefGraph()
    for t in spec:
        ref_g.add_task(t["kind"], [(RefData(n, int(sz)), RefMode(m)) for n, sz, m in t["accesses"]],
                       flops=float(t["flops"]))
    gpus = sorted({int(x) for x in rng.integers(1, 9, 3)})
    caps = (0, int(rng.integers(1, 8)) * MIB)
    items = configs(g, gpus, SMALL_SPECS, (seed,), caps)
    plan, batch = plan_and_batch(items)
    got = ep.run_episodes(plan, batch, device="cpu", emit_schedule=True)
    ref_plan = ref_ep.build_plan(ref_g, ref_paper_machine(gpus[0]), n_u=plan.n_u)
    assert_plans_equal(ref_plan, plan)
    want = ref_ep.run_episodes(ref_plan, batch, config=REF_CFG["0"], emit_schedule=True)
    for key in ("makespan", "total_bytes", "n_placed"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in SCHEDULE:
        np.testing.assert_array_equal(got["schedule"][key], want["schedule"][key], err_msg=key)


def test_cases_exercise_what_they_claim(parity_runs):
    """The capacity cases evict (write-backs show in ``evict_b``), the
    chain case needs all eight LRU rounds in one step (with seven, that
    step writes back less), the assorted graph has no two equal sizes, and
    the wide graph's priorities are a handful of values, so its selections
    tie."""
    plan = parity_runs["wide"][2]
    assert len(np.unique(plan.prio.astype(np.float32)[:plan.n])) <= 8 and plan.n > 300
    for label in ("cap8MiB", "cap-mixed", "evict8", "assorted", "wide"):
        assert (parity_runs[label][-1]["schedule"]["evict_b"] > 0).any(), label
    graph_key, items, plan, batch, pad_to, extra, got = parity_runs["evict8"]
    assert (got["schedule"]["evict_b"][:, 10] == 8 * MIB).all()  # the 11th placement
    args = ep.episode_inputs(plan, batch, torch.device("cpu"))
    seven = pytest.MonkeyPatch()
    seven.setattr(se, "_K_EVICT", 7)
    try:
        *_, sched7 = se.episode_plain(*args, n_steps=plan.n, use_cap=True, emit=True)
    finally:
        seven.undo()
    assert (sched7[7][:len(batch), 10] == 7 * MIB).all()
    assert len(set(s for t in assorted_spec() for _, s, _ in t["accesses"])) == 14


def test_fma_f32_is_a_single_rounding():
    """The plain version's multiply-add equals the correctly rounded f32
    result (exact rational arithmetic), where an unfused one does not."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    a, b, c = (rng.standard_normal(4096).astype(np.float32) * s for s in (1.0, 3.0, 7.0))
    got = se.fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    unfused = (a * b + c).astype(np.float32)

    def nearest(x, y, z):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        best = min((np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))),
                   key=lambda v: (abs(Fraction(float(v)) - exact), int(np.float32(v).view(np.int32)) & 1))
        return best

    want = np.array([nearest(*v) for v in zip(a, b, c)], dtype=np.float32)
    assert np.array_equal(got, want)
    assert not np.array_equal(unfused, want)


# ---------------------------------------------------------------------------
# the selection order: a property of the plan, which the kernel reads


@pytest.mark.parametrize("label", [c[0] for c in cases()])
def test_plan_order_is_the_plain_scans_selection(parity_runs, label):
    """Every configuration of a case selects the same tasks, and the plan's
    order is that selection: equal on the active steps, as long as they
    are; the other steps take task 0."""
    graph_key, items, plan, batch, pad_to, extra, got = parity_runs[label]
    tid, act = got["schedule"]["tid"], got["schedule"]["act"]
    assert (tid == tid[:1]).all() and (act == act[:1]).all()
    assert plan.order.dtype == np.int32 and len(plan.order) == act[0].sum() == plan.n
    np.testing.assert_array_equal(tid[0][act[0]], plan.order)
    assert (tid[0][~act[0]] == 0).all() and not act[0][plan.n:].any()


@pytest.mark.parametrize("kind", ["cholesky", "lu", "qr"])
def test_plan_order_on_the_nt16_tile_graphs(kind):
    """The paper's NT 16 graphs: the order is the plain scan's selection."""
    items = configs(tile_graph(kind, 16, 512), (8,), ("heft",), (1234,))
    plan, batch = plan_and_batch(items)
    got = ep.run_episodes(plan, batch, device="cpu", emit_schedule=True)
    assert got["schedule"]["act"].all() and len(plan.order) == plan.n
    np.testing.assert_array_equal(got["schedule"]["tid"][0], plan.order)
    want = se.selection_order(plan.indeg0, plan.prio.astype(np.float32), plan.succ_ids)
    np.testing.assert_array_equal(plan.order, want)


def test_order_breaks_f32_ties_by_index():
    """Two f64 ranks that round to one f32 value tie, and the lesser index
    wins though its f64 rank is the greater one's: the order is built from
    the f32 priorities the scan compares, as the plain scan selects."""
    plan, batch = _small_setup()
    args = list(ep.episode_inputs(plan, batch, torch.device("cpu")))
    assert np.flatnonzero(plan.indeg0[:plan.n] == 0).tolist() == [0]  # one source
    lo, hi = sorted(s for s in plan.succ_ids[0] if s < plan.n)[:2]  # two of its successors
    prio64 = np.full(plan.n_pad, 2.0)
    prio64[0] = 4.0
    prio64[lo], prio64[hi] = 3.0, 3.0 + 2.0 ** -30
    prio32 = prio64.astype(np.float32)
    assert prio64[hi] > prio64[lo] and prio32[hi] == prio32[lo]
    order = se.selection_order(plan.indeg0, prio32, plan.succ_ids)
    assert order[:3].tolist() == [0, lo, hi]
    args[7] = torch.from_numpy(prio32)
    *_, sched = se.episode_plain(*args, n_steps=plan.n, use_cap=False, emit=True)
    np.testing.assert_array_equal(sched[0][0].numpy(), order)
    with pytest.raises(ValueError, match="f32"):
        se.selection_order(plan.indeg0, prio64, plan.succ_ids)
    with pytest.raises(ValueError, match="NaN"):
        se.selection_order(plan.indeg0, np.full_like(prio32, np.nan), plan.succ_ids)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_order_follows_the_plain_scan_on_tied_and_cut_priorities(seed):
    """Priorities drawn from three values (most selections tie), a few of
    them -inf (such a task, and all it feeds, is never taken): the order
    is the plain scan's selection on its active steps, and every later
    step is inactive on task 0."""
    plan, batch = _small_setup()
    args = list(ep.episode_inputs(plan, batch, torch.device("cpu")))
    rng = np.random.default_rng(seed)
    prio = rng.choice(np.array([1.0, 2.0, 3.0], np.float32), size=plan.n_pad)
    prio[rng.choice(np.arange(1, plan.n), size=seed % 3, replace=False)] = -np.inf
    args[7] = torch.from_numpy(prio)
    order = se.selection_order(plan.indeg0, prio, plan.succ_ids)
    assert (len(order) == plan.n) == (seed % 3 == 0)
    *_, sched = se.episode_plain(*args, n_steps=plan.n + 3, use_cap=False, emit=True)
    tid, act = sched[0].numpy(), sched[2].numpy()
    assert (tid == tid[:1]).all() and (act == act[:1]).all()
    assert act[0].sum() == len(order) and act[0][:len(order)].all()
    np.testing.assert_array_equal(tid[0][:len(order)], order)
    assert (tid[0][len(order):] == 0).all()


def test_state_words_hold_no_ready_set():
    """A configuration's state is ready_t, res_mask and writer and, with a
    capacity, touch: QR NT 16 on the paper machine takes about 9.3 KB."""
    assert se.state_words(128, 10, 3, False) == 128 + 2 * 10
    assert se.state_words(128, 10, 3, True) == 128 + 2 * 10 + 3 * 10
    plan = ep.build_plan(tile_graph("qr", 16, 512), paper_machine(8), n_u=9)
    assert 4 * se.state_words(plan.n_pad, plan.n_data + 1, plan.n_u, False) == 9288


def test_plan_tables_are_built_once_and_bound_to_their_inputs():
    """The plan's tables on a device (order and task records) are made once
    and bound to the plan tensors episode_inputs hands out there: the
    order is the plan's, the records pack those tensors' rows."""
    plan, batch = _small_setup()
    cpu = torch.device("cpu")
    args = ep.episode_inputs(plan, batch, cpu)
    tables = ep.episode_tables(plan, cpu)
    assert ep.episode_tables(plan, "cpu") is tables
    assert all(a is b for a, b in zip(ep.episode_inputs(plan, batch, cpu, len(batch) + 1)[:13],
                                      args[:13]))
    assert tables.matches(args) and tables.order.dtype == torch.int32
    np.testing.assert_array_equal(tables.order.numpy(), plan.order)
    assert torch.equal(tables.records, se.task_records(args))
    derived = se.plan_tables(args)
    assert torch.equal(derived.order, tables.order) and torch.equal(derived.records, tables.records)


def test_wrapper_refuses_tables_of_other_inputs():
    """Tables go only with the tensors they were derived from, unchanged:
    new priorities (a new tensor, or the same one changed in place) with
    the plan's tables are refused, on the CPU as on the card; tables
    derived from the new inputs are taken, and their order follows the new
    priorities, as the plain scan does."""
    plan, batch = _small_setup()
    args = list(ep.episode_inputs(plan, batch, torch.device("cpu")))
    tables = ep.episode_tables(plan, "cpu")
    run = partial(se.episode_scan, n_steps=plan.n, use_cap=False, emit=True)
    run(*args, tables=tables)
    prio = torch.from_numpy(np.arange(plan.n_pad, dtype=np.float32))  # last task first
    new = list(args)
    new[7] = prio
    with pytest.raises(ValueError, match="derived from other inputs"):
        run(*new, tables=tables)
    mine = se.plan_tables(new)
    got = run(*new, tables=mine)
    assert not np.array_equal(mine.order.numpy(), plan.order)
    np.testing.assert_array_equal(got[3][0][0].numpy(), mine.order.numpy())
    copy = [a.clone() for a in args]
    copied = se.plan_tables(copy)
    run(*copy, tables=copied)
    copy[7].mul_(-1.0)  # in place: the version moves on
    with pytest.raises(ValueError, match="changed in place"):
        run(*copy, tables=copied)
    with pytest.raises(ValueError, match="derived from other inputs"):
        run(*copy, tables=tables)


def test_task_records_pack_the_plan_rows():
    """Each task's record, as the kernel fetches it: reads, one-hop times
    and sizes, writes and their sizes, successors, then the two durations
    (the floats' bits), each section zero-padded to 16 bytes."""
    plan, batch = _small_setup()
    args = ep.episode_inputs(plan, batch, torch.device("cpu"))
    rec = se.task_records(args)
    r, w, s_ = plan.r_pad, plan.w_pad, plan.s_pad
    assert rec.shape == (plan.n_pad, se.record_words(r, w, s_)) and rec.dtype == torch.int32
    assert rec.is_contiguous() and rec.shape[1] % 4 == 0
    f = rec.view(torch.float32)
    at = 0
    for want, width in zip((*args[:6], torch.stack([args[8], args[9]], dim=1)),
                           (r, r, r, w, w, s_, 2)):
        span = -(-width // 4) * 4
        got = rec[:, at:at + width] if want.dtype == torch.int32 else f[:, at:at + width]
        assert torch.equal(got, want) and (rec[:, at + width:at + span] == 0).all()
        at += span
    assert at == rec.shape[1]


def _assert_plans_fit(label, R, r_pad, w_pad, s_pad):
    per = 4 * se.warp_words(R, r_pad, w_pad, s_pad)
    assert se.launch_plan(R, r_pad, w_pad, s_pad) == (se.WARPS, se.WARPS * per), label
    assert se.WARPS * per <= se.SMEM_LIMIT, label


def test_launch_plan_fits_every_case():
    """The kernel's launch plan (configurations a block, shared bytes):
    :data:`WARPS` configurations a block fit the card's 227 KB on every
    case; a warp whose share cannot fit, or a machine of more than 32
    resources (one lane each), is refused, and a block takes one warp
    where two would not fit."""
    for label, graph_key, gpus, specs, seeds, caps, pad_to, extra in cases():
        plan, _ = plan_and_batch(configs(case_graph(graph_key), gpus, specs[:1], seeds[:1]))
        _assert_plans_fit(label, plan.n_res, plan.r_pad, plan.w_pad, plan.s_pad)
    assert se.launch_plan(12, 16384, 2, 16) is None
    assert se.launch_plan(se.MAX_RES + 1, 4, 2, 16) is None
    assert se.launch_plan(se.MAX_RES, 4, 2, 16) is not None
    per = 4 * se.warp_words(12, 8192, 2, 16)
    assert 2 * per > se.SMEM_LIMIT >= per
    assert se.launch_plan(12, 8192, 2, 16) == (1, per)


@pytest.mark.parametrize("kind", ["cholesky", "lu", "qr"])
def test_launch_plan_fits_at_scale(kind):
    """The plan fits at NT 16, 32 and 64 on the paper machine."""
    for nt in (16, 32, 64):
        plan = ep.build_plan(tile_graph(kind, nt, 512), paper_machine(8), n_u=9)
        _assert_plans_fit(f"{kind}{nt}", plan.n_res, plan.r_pad, plan.w_pad, plan.s_pad)


# ---------------------------------------------------------------------------
# invariance properties: padding and batch order are bit-level no-ops


def _small_setup():
    items = configs(tile_graph("cholesky", 4), (2,), SMALL_SPECS, (1,))
    for c, seed in zip(items, (1, 2, 3, 4, 5)):
        c["seed"] = seed
    return plan_and_batch(items)


def _take(batch, idx):
    return dataclasses.replace(
        batch, **{f.name: getattr(batch, f.name)[idx] for f in dataclasses.fields(batch)}
    )


@pytest.fixture(scope="module")
def small_episode():
    plan, batch = _small_setup()
    return plan, batch, ep.run_episodes(plan, batch, device="cpu", emit_schedule=True)


@given(pad_to=st.sampled_from([8, 16, 24]), extra=st.sampled_from([0, 7]))
@settings(max_examples=12, deadline=None)
def test_padding_invariance(small_episode, pad_to, extra):
    """Batch padding and step padding never change any configuration's
    result, to the bit."""
    plan, batch, base = small_episode
    out = ep.run_episodes(plan, batch, device="cpu", pad_to=pad_to, extra_steps=extra,
                          emit_schedule=True)
    for key in ("makespan", "total_bytes", "n_placed"):
        np.testing.assert_array_equal(out[key], base[key], err_msg=key)
    for key in SCHEDULE:
        np.testing.assert_array_equal(out["schedule"][key][:, :plan.n], base["schedule"][key])
    assert not out["schedule"]["act"][:, plan.n:].any()


@given(perm=st.permutations(list(range(5))))
@settings(max_examples=12, deadline=None)
def test_batch_permutation_invariance(small_episode, perm):
    """Row order on the batch axis is irrelevant: configurations don't
    interact."""
    plan, batch, base = small_episode
    idx = np.array(perm)
    out = ep.run_episodes(plan, _take(batch, idx), device="cpu")
    for key in ("makespan", "total_bytes", "n_placed"):
        np.testing.assert_array_equal(out[key], base[key][idx], err_msg=key)


def test_every_task_placed(small_episode):
    plan, _, base = small_episode
    assert (base["n_placed"] == plan.n).all()


def test_pad_to_smaller_than_the_batch_raises(small_episode):
    plan, batch, _ = small_episode
    with pytest.raises(ValueError, match="pad_to"):
        ep.run_episodes(plan, batch, device="cpu", pad_to=4)


# ---------------------------------------------------------------------------
# run_batch


def test_run_batch_preserves_input_order():
    graph = tile_graph("cholesky", 4)
    m2, m4 = paper_machine(2), paper_machine(4)
    items = [
        {"graph": graph, "machine": m, "strategy": s, "seed": sd, "noise": NOISE}
        for sd in (1, 2) for m in (m2, m4) for s in ("heft", "dada?alpha=0.5")
    ]
    fwd = run_batch(items, device="cpu")
    rev = run_batch(list(reversed(items)), device="cpu")
    for a, b in zip(fwd, reversed(rev)):
        assert isinstance(a, BatchResult)
        assert a.strategy == b.strategy and a.seed == b.seed
        assert a.makespan == b.makespan and a.total_bytes == b.total_bytes
        assert a.n_placed == b.n_placed == len(graph)


def test_capacity_axis_adds_traffic():
    """A tight device-memory cap can only add transferred bytes."""
    graph = tile_graph("cholesky", 8)
    machine = paper_machine(2)
    items = [
        {"graph": graph, "machine": machine, "strategy": "dada?alpha=0.5", "seed": 7,
         "noise": NOISE, "capacity": cap}
        for cap in (0, 8 * MIB)
    ]
    unbounded, bounded = run_batch(items, device="cpu")
    assert bounded.total_bytes > unbounded.total_bytes
    assert np.isfinite(bounded.makespan)


@pytest.mark.parametrize("kind", ["cholesky", "lu", "qr"])
def test_run_batch_equals_reference(kind):
    """Config by config, over two graphs, three machines, capacities and
    the figure specs (the reference chunks and pads each group; the port
    runs it whole): exactly equal."""
    specs = FIGURE_SPECS
    items = configs(tile_graph(kind, 4), (1, 3, 8), specs, (1234, 1235), (0, 4 * MIB))
    items += configs(tile_graph("cholesky", 6), (2,), specs, (5,))
    machines = {id(c["machine"]): ref_paper_machine(
        sum(r.is_accelerator for r in c["machine"].resources)) for c in items}
    ref_graphs = {id(tile_graph(kind, 4)): ref_graph((kind, 4)),
                  id(tile_graph("cholesky", 6)): ref_graph(("cholesky", 6))}
    ref_items = [dict(c, graph=ref_graphs[id(c["graph"])], machine=machines[id(c["machine"])])
                 for c in items]
    got = run_batch(items, device="cpu")
    want = ref_run_batch(ref_items, config=REF_CFG["0"])
    assert len(got) == len(want) == len(items)
    for a, b in zip(got, want):
        assert (a.strategy, a.seed) == (b.strategy, b.seed)
        assert a.makespan == b.makespan and a.total_bytes == b.total_bytes
        assert a.total_flops == b.total_flops and a.gflops == b.gflops


# ranking fidelity (tests/test_episode.py:105-136): the port's surrogate
# against the reference's exact engine
RANK_SPECS = ("heft", "ws", "dada?alpha=0", "dada?alpha=0.5&use_cp=1")
RANK_SEEDS = tuple(1234 + i for i in range(20))
MARGIN = 0.10


def _assert_separated_pairs_ordered_alike(oracle, surrogate, axis, label, specs=RANK_SPECS):
    for i, a in enumerate(specs):
        for b in specs[i + 1:]:
            oa, ob = oracle[a][axis], oracle[b][axis]
            if abs(oa - ob) <= MARGIN * max(abs(oa), abs(ob)):
                continue
            sa, sb = surrogate[a][axis], surrogate[b][axis]
            assert (oa < ob) == (sa < sb), (
                f"{label}: oracle orders {a} vs {b} as {oa:.4g} vs {ob:.4g} "
                f"but the port's surrogate says {sa:.4g} vs {sb:.4g}"
            )


@pytest.mark.parametrize("gpus", [2, 8])
@pytest.mark.parametrize("kind", ["cholesky", "lu", "qr"])
def test_ranking_fidelity(kind, gpus):
    rg, rm = ref_graph((kind, 8)), ref_paper_machine(gpus)
    oracle = {}
    for spec in RANK_SPECS:
        runs = [ref_run_simulation(rg, rm, ref_resolve(spec), seed=s, noise=NOISE)
                for s in RANK_SEEDS]
        oracle[spec] = (float(np.mean([r.makespan for r in runs])),
                        float(np.mean([r.total_bytes for r in runs])))
    items = configs(tile_graph(kind, 8), (gpus,), RANK_SPECS, RANK_SEEDS)
    results = run_batch(items, device="cpu")
    surrogate = {}
    for k, spec in enumerate(RANK_SPECS):
        rs = results[k * len(RANK_SEEDS):(k + 1) * len(RANK_SEEDS)]
        assert all(r.strategy == spec for r in rs)
        surrogate[spec] = (float(np.mean([r.makespan for r in rs])),
                           float(np.mean([r.total_bytes for r in rs])))
    tag = f"{kind} nt=8 gpus={gpus}"
    _assert_separated_pairs_ordered_alike(oracle, surrogate, 0, f"{tag} makespan")
    _assert_separated_pairs_ordered_alike(oracle, surrogate, 1, f"{tag} bytes",
                                          specs=tuple(s for s in RANK_SPECS if s != "ws"))
    assert max(RANK_SPECS, key=lambda s: surrogate[s][0]) == "ws"


# ---------------------------------------------------------------------------
# the card: no silent CPU path, and the wrapper's refusals


def test_cuda_without_a_card_raises(small_episode):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    plan, batch, _ = small_episode
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ep.run_episodes(plan, batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_batch(configs(tile_graph("cholesky", 4), (2,), ("heft",), (1,)))


def test_wrapper_on_cpu_tensors_is_the_plain_version(small_episode):
    plan, batch, base = small_episode
    args = ep.episode_inputs(plan, batch, torch.device("cpu"))
    got = se.episode_scan(*args, n_steps=plan.n, use_cap=False, emit=False)
    want = se.episode_plain(*args, n_steps=plan.n, use_cap=False, emit=False)
    assert se.episode_scan.launches == 0 or torch.cuda.is_available()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert np.array_equal(got[0].numpy()[:len(batch)].astype(np.float64), base["makespan"])


def test_wrapper_refuses_malformed_inputs(small_episode):
    plan, batch, _ = small_episode
    args = list(ep.episode_inputs(plan, batch, torch.device("cpu")))
    bad = list(args)
    bad[1] = bad[1].double()  # read_t in f64
    with pytest.raises(ValueError, match="read_t"):
        se.episode_scan(*bad, n_steps=plan.n, use_cap=False, emit=False)
    bad = list(args)
    bad[20] = bad[20][:, :-1].contiguous()  # noise one column short
    with pytest.raises(ValueError, match="noise"):
        se.episode_scan(*bad, n_steps=plan.n, use_cap=False, emit=False)
    for i, name, value in ((15, "mem_col", plan.n_u), (16, "link_grp", -1), (0, "read_ids", -1)):
        bad = list(args)
        bad[i] = bad[i].clone()
        bad[i].view(-1)[0] = value
        with pytest.raises(ValueError, match=name):
            se.episode_scan(*bad, n_steps=plan.n, use_cap=False, emit=False)
    with pytest.raises(ValueError, match="23 tensors"):
        se.episode_scan(*args[:-1], n_steps=plan.n, use_cap=False, emit=False)


def test_episode_inputs_leave_the_batch_unpadded(small_episode):
    """Without ``pad_to`` the batch axes keep one row a configuration
    (one block each on the card); ``pad_to`` adds rows."""
    plan, batch, _ = small_episode
    B = len(batch)
    for pad_to, rows in ((None, B), (B + 3, B + 3)):
        args = ep.episode_inputs(plan, batch, torch.device("cpu"), pad_to)
        assert [a.shape[0] for a in args[13:22]] == [rows] * 9


def test_padded_rows_run_on_resource_zero(small_episode):
    """A padded row has no valid resource: every score is inf, so each
    step places its task on resource 0. It shares nothing with the real
    rows, which ``run_episodes`` alone returns."""
    plan, batch, base = small_episode
    B = len(batch)
    args = ep.episode_inputs(plan, batch, torch.device("cpu"), B + 2)
    mk, _, npl, sched = se.episode_plain(*args, n_steps=plan.n, use_cap=False, emit=True)
    assert (npl[B:] == plan.n).all() and sched[2][B:].all()
    assert (sched[1][B:] == 0).all()
    assert np.array_equal(mk[:B].numpy().astype(np.float64), base["makespan"])


def test_kernel_source_names_what_it_replaces():
    src = se._SRC
    text = src.read_text()
    for name in ("episode.py::_build_episode_fn", "sched_score.py:121", "__fmaf_rn"):
        assert name in text
    assert 'extern "C" int repro_episode_scan' in text
    assert src in se.SOURCES
    assert se._lib is None or torch.cuda.is_available()  # built at first use
