"""The port's distribution planners (``repro_torch.dist``: sched_bridge,
elastic, straggler) against the JAX package's numpy ones.

The inputs are those of tests/test_dist.py (expert placement, layer
partitioning, elastic re-planning, stragglers) and of
tests/test_runtime.py's eviction-priced replan, plus the branches those
tests leave out (α 0, memory pressure with and without occupancy, groups
that vanish, refusals). Every output must equal the reference's: the
planners are float64 numpy in both packages, the same operations in the
same order. The dual-approximation bound runs at fixed seeds (no
hypothesis). ``ElasticReplanner`` follows the port's engine through a
drain and an attach as it follows the reference's (tests/test_faults.py).
"""
import numpy as np
import pytest

from repro.configs.paper_machine import paper_machine as jax_paper_machine
from repro.core import Simulator as JaxSimulator
from repro.dist import elastic as jel
from repro.dist import sched_bridge as jsb
from repro.dist import straggler as jst
from repro.linalg.cholesky import cholesky_graph as jax_cholesky_graph
from repro.sched import resolve as jax_resolve
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.core import Simulator
from repro_torch.dist import elastic as tel
from repro_torch.dist import sched_bridge as tsb
from repro_torch.dist import straggler as tst
from repro_torch.linalg.cholesky import cholesky_graph
from repro_torch.sched import resolve


def _same_placement(a, b):
    for name in ("assignment", "group_load", "perm", "inv_perm"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.moved_experts == b.moved_experts


def _both(fn_name, *args, **kwargs):
    """``sched_bridge.fn_name`` of the port and of the reference."""
    return getattr(tsb, fn_name)(*args, **kwargs), getattr(jsb, fn_name)(*args, **kwargs)


# ---------------------------------------------------------------------------
# expert placement
def _masses():
    """(name, mass, groups): tests/test_dist.py's draws and a few more."""
    out = [
        ("pareto64", np.random.default_rng(0).pareto(1.5, size=64) * 1000, 8),
        ("pareto32", np.random.default_rng(1).pareto(1.0, size=32) * 100 + 1, 4),
        ("uniform64", np.random.default_rng(2).uniform(10, 20, size=64), 8),
        ("ties", np.ones(12), 3),
        ("grok", np.random.default_rng(5).pareto(1.5, 8) * 100, 4),
        ("kimi", np.random.default_rng(6).pareto(1.5, 384) * 100, 4),
    ]
    return out


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("alpha", [0.0, 1.0, 0.3])
@pytest.mark.parametrize("with_prev", [False, True])
def test_plan_expert_placement_equals_reference(case, alpha, with_prev):
    name, mass, G = _masses()[case]
    prev = None
    if with_prev:
        prev = np.random.default_rng(case).integers(0, G, len(mass))
        prev[::5] = -1  # experts with no home yet
    got, want = _both("plan_expert_placement", mass, G, prev_assignment=prev, alpha=alpha)
    _same_placement(got, want)
    assert (np.bincount(got.assignment, minlength=G) == len(mass) // G).all()


@pytest.mark.parametrize("resident", [None, "given"])
@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("penalty", [1.0, 0.01])
def test_plan_expert_placement_memory_pressure_equals_reference(resident, with_prev, penalty):
    rng = np.random.default_rng(9)
    mass = rng.uniform(1, 10, 16)
    prev = rng.integers(0, 4, 16) if with_prev else None
    kw = dict(prev_assignment=prev, alpha=0.5, expert_bytes=10.0, group_hbm_bytes=45.0,
              mem_penalty=penalty)
    if resident == "given":
        kw["group_resident_bytes"] = [45.0, 30.0, 0.0, 40.0]
    got, want = _both("plan_expert_placement", mass, 4, **kw)
    _same_placement(got, want)


def test_expert_replanning_prices_eviction_cost_equals_reference():
    """tests/test_runtime.py's case: a nearly-full group repels incoming
    experts unless they were already there."""
    mass = [5.0, 5.0, 4.0, 4.0]
    kw = dict(prev_assignment=[0, 1, -1, -1], alpha=0.1)
    free = _both("plan_expert_placement", mass, 2, **kw)
    priced = _both("plan_expert_placement", mass, 2, **kw, expert_bytes=10.0,
                   group_hbm_bytes=15.0, group_resident_bytes=[15.0, 5.0])
    for got, want in (free, priced):
        _same_placement(got, want)
    assert free[0].assignment[2] == 0 and priced[0].assignment[2] == 1
    assert sorted(priced[0].assignment.tolist()) == [0, 0, 1, 1]


@pytest.mark.parametrize("args,kwargs,match", [
    ((np.ones(10), 4), {}, "divisible"),
    ((np.ones(0), 1), {}, "divisible"),
    ((np.ones(8), 0), {}, "divisible"),
    ((np.ones(8), 2), {"prev_assignment": [0, 1]}, "prev_assignment length"),
    ((np.ones(8), 2), {"expert_bytes": 1.0, "group_hbm_bytes": 4.0,
                       "group_resident_bytes": [1.0]}, "group_resident_bytes length"),
])
def test_plan_expert_placement_refuses_what_the_reference_refuses(args, kwargs, match):
    for mod in (tsb, jsb):
        with pytest.raises(ValueError, match=match):
            mod.plan_expert_placement(*args, **kwargs)


def test_expert_placement_properties():
    """tests/test_dist.py's three placement properties, on the port."""
    mass = np.random.default_rng(0).pareto(1.5, size=64) * 1000
    pl = tsb.plan_expert_placement(mass, 8)
    assert (np.bincount(pl.assignment, minlength=8) == 8).all()
    assert sorted(pl.perm.tolist()) == list(range(64))
    assert (pl.perm[pl.inv_perm] == np.arange(64)).all()
    mass = np.random.default_rng(1).pareto(1.0, size=32) * 100 + 1
    pl = tsb.plan_expert_placement(mass, 4)
    assert pl.group_load.max() <= np.array([mass[g::4].sum() for g in range(4)]).max() * 1.05
    rng = np.random.default_rng(2)
    mass = rng.uniform(10, 20, size=64)
    first = tsb.plan_expert_placement(mass, 8)
    mass2 = mass * rng.uniform(0.95, 1.05, size=64)
    second = tsb.plan_expert_placement(mass2, 8, prev_assignment=first.assignment, alpha=1.0)
    fresh = tsb.plan_expert_placement(mass2, 8, prev_assignment=None, alpha=0.0)
    assert second.moved_experts <= 16
    assert second.moved_experts <= int((fresh.assignment != first.assignment).sum())


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_expected_a2a_fraction_equals_reference(seed):
    """tests/test_dist.py's affinity case: by-source masses with a dominant
    group per expert, round robin against the affinity placement."""
    rng = np.random.default_rng(seed)
    G, E = 4, 32
    by_source = rng.pareto(1.0, size=(G, E)) * 10
    perm = rng.permutation(E)
    for g in range(G):
        by_source[g, perm[g * (E // G):(g + 1) * (E // G)]] *= 20
    rr = np.arange(E) % G
    pl = tsb.plan_expert_placement(by_source.sum(0), G, prev_assignment=by_source.argmax(0))
    for assignment in (rr, pl.assignment):
        got, want = _both("expected_a2a_fraction", by_source, assignment)
        assert got == want
    assert tsb.expected_a2a_fraction(by_source, pl.assignment) < tsb.expected_a2a_fraction(
        by_source, rr)
    assert tsb.expected_a2a_fraction(np.zeros((G, E)), rr) == 0.0


# ---------------------------------------------------------------------------
# layer partitioning
def _chains():
    rng = np.random.default_rng(12)
    out = [([1.0] * 16, 4), ([], 3), ([0.0, 0.0], 2), ([5.0], 4), ([1.0, 9.0, 1.0, 1.0], 2)]
    for _ in range(40):
        n = int(rng.integers(4, 41))
        out.append((rng.uniform(0.1, 10.0, n).tolist(), int(rng.integers(2, 7))))
    return out


@pytest.mark.parametrize("case", range(45))
def test_partition_layers_equals_reference(case):
    costs, k = _chains()[case]
    got, want = _both("partition_layers", costs, k)
    assert got == want and len(got) == k
    assert got[0] == 0 and all(a <= b for a, b in zip(got, got[1:]))
    loads, want_loads = _both("stage_loads", costs, got)
    assert loads == want_loads
    if costs:  # the dual approximation's bound
        assert max(loads) <= 2.0 * max(max(costs), sum(costs) / k) + 1e-9
    assert tsb._greedy_starts(costs, 3.0) == jsb._greedy_starts(costs, 3.0)


def test_partition_layers_balanced_and_refusal():
    assert tsb.partition_layers([1.0] * 16, 4) == [0, 4, 8, 12]
    assert max(tsb.stage_loads([1.0] * 16, [0, 4, 8, 12])) == 4.0
    for mod in (tsb, jsb):
        with pytest.raises(ValueError, match="at least one stage"):
            mod.partition_layers([1.0], 0)


# ---------------------------------------------------------------------------
# elastic
@pytest.mark.parametrize("n", [512, 256, 300, 17, 16, 1000, 3])
@pytest.mark.parametrize("axis", [16, 4, 1])
def test_choose_mesh_shape_equals_reference(n, axis):
    try:
        want = jel.choose_mesh_shape(n, axis)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(",")[0]):
            tel.choose_mesh_shape(n, axis)
        return
    assert tel.choose_mesh_shape(n, axis) == want


def test_choose_mesh_shape_refusals():
    assert tel.choose_mesh_shape(512) == (32, 16) and tel.choose_mesh_shape(300) == (16, 16)
    with pytest.raises(ValueError, match="model_axis"):
        tel.choose_mesh_shape(8, 0)


def _same_plan(a, b):
    assert a.mesh_shape == b.mesh_shape and a.n_devices == b.n_devices
    _same_placement(a.placement, b.placement)


@pytest.mark.parametrize("n_experts,mass", [(64, "ones"), (64, "pareto"), (24, "pareto"),
                                            (8, None), (384, "pareto")])
def test_replan_equals_reference(n_experts, mass):
    """A pod shrinking 256 -> 128 -> 32 devices and back to 256, each step
    with the previous assignment (groups that vanish carry no affinity)."""
    rng = np.random.default_rng(n_experts)
    m = {"ones": np.ones(n_experts), "pareto": rng.pareto(1.5, n_experts) * 10, None: None}[mass]
    prev_t = prev_j = None
    plans = []
    for n, axis in ((256, 16), (128, 16), (32, 16), (40, 8), (256, 16)):
        got = tel.replan(n, n_experts=n_experts, routing_mass=m, prev_assignment=prev_t,
                         model_axis=axis)
        want = jel.replan(n, n_experts=n_experts, routing_mass=m, prev_assignment=prev_j,
                          model_axis=axis)
        _same_plan(got, want)
        plans.append(got)
        prev_t = got.placement.assignment
        prev_j = want.placement.assignment
    for a, b in zip(plans, plans[1:]):
        assert tel.moved_experts(a, b) == int(np.count_nonzero(
            a.placement.assignment != b.placement.assignment))
    assert tel.moved_experts(None, None) == 0
    assert tel.moved_experts(plans[0], None) == n_experts == tel.moved_experts(None, plans[0])


def test_replan_after_failure_keeps_surviving_experts():
    plan0 = tel.replan(256, n_experts=64, routing_mass=np.ones(64))
    plan1 = tel.replan(128, n_experts=64, routing_mass=np.ones(64),
                       prev_assignment=plan0.placement.assignment)
    assert plan0.mesh_shape == (16, 16) and plan1.mesh_shape == (8, 16)
    assert tel.moved_experts(plan0, plan1) <= 32
    with pytest.raises(ValueError, match="routing_mass length"):
        tel.replan(256, n_experts=64, routing_mass=np.ones(8))


def test_moved_experts_refuses_plans_of_other_sizes():
    a = tel.replan(256, n_experts=64)
    b = tel.replan(256, n_experts=32)
    with pytest.raises(ValueError, match="different expert counts"):
        tel.moved_experts(a, b)


def _history(rp):
    return [(t, ev, nd, None if p is None else (p.mesh_shape, p.placement.assignment.tolist()))
            for t, ev, nd, p in rp.history]


@pytest.mark.parametrize("per_worker,axis", [(16, 16), (4, 16), (8, 8)])
def test_elastic_replanner_follows_the_engine_as_the_reference(per_worker, axis):
    """tests/test_faults.py's case on both engines: GPU 0 drained at a
    quarter of the fault-free makespan and back at 0.6 (per_worker 4 at
    axis 16 drops below one TP group and keeps the last viable plan)."""
    mass = np.random.default_rng(1).pareto(1.5, 32) * 10
    out = []
    for mod, Sim, machine, strategy, graph in (
            (tel, Simulator, paper_machine, lambda: resolve("heft", device="cpu"), cholesky_graph),
            (jel, JaxSimulator, jax_paper_machine, lambda: jax_resolve("heft"),
             jax_cholesky_graph)):
        base = Sim(graph(6, 256, with_fns=False), machine(4), strategy(), seed=0, noise=0.0).run()
        m = machine(4)
        sim = Sim(graph(6, 256, with_fns=False), m, strategy(), seed=0, noise=0.0)
        rp = mod.ElasticReplanner(devices_per_worker=per_worker, n_experts=32, model_axis=axis,
                                  routing_mass=mass).attach_to(sim)
        gpu0 = m.gpus[0].rid
        sim.inject("detach", gpu0, at=base.makespan * 0.25, mode="drain")
        sim.inject("attach", gpu0, at=base.makespan * 0.6)
        sim.run()
        out.append((_history(rp), rp.total_moved,
                    None if rp.current is None else rp.current.placement.assignment.tolist()))
    assert out[0] == out[1]
    events = [(ev, nd) for _, ev, nd, _ in out[0][0]]
    n_gpus = len(paper_machine(4).gpus)
    assert events == [("init", per_worker * n_gpus), ("detach", per_worker * (n_gpus - 1)),
                      ("attach", per_worker * n_gpus)]


def test_elastic_replanner_refuses_no_devices():
    for mod in (tel, jel):
        with pytest.raises(ValueError, match="devices_per_worker"):
            mod.ElasticReplanner(devices_per_worker=0, n_experts=8)


# ---------------------------------------------------------------------------
# stragglers
def _script(rng, n, total, ema, steps):
    """A seeded run of plan / observe / deactivate / reactivate."""
    ops = []
    for _ in range(steps):
        r = rng.random()
        if r < 0.15:
            ops.append(("deactivate", int(rng.integers(0, n))))
        elif r < 0.3:
            ops.append(("reactivate", int(rng.integers(0, n))))
        else:
            speed = rng.uniform(0.2, 4.0, n)
            speed[rng.random(n) < 0.1] = 0.0  # a zero-time report
            ops.append(("observe", speed))
    return ops


def _run_straggler(mod, n, total, ema, ops):
    p = mod.StragglerPlanner(n_shards=n, total_microbatches=total, ema=ema)
    out = [p.plan().tolist()]
    for op, arg in ops:
        try:
            if op == "observe":
                plan = p.plan()
                p.observe(arg * plan, plan)
                out.append(("mk", p.expected_makespan(plan)))
            else:
                getattr(p, op)(arg)
            out.append(p.plan().tolist())
        except ValueError as e:
            out.append(("err", str(e)))
    out.append((p.active.tolist(), p.n_active, p.n_observations, p._cost.tolist()))
    return out


@pytest.mark.parametrize("n,total,ema", [(4, 32, 1.0), (3, 12, 0.5), (8, 9, 0.3), (2, 8, 0.5),
                                         (6, 200, 0.8), (5, 5, 1.0)])
def test_straggler_planner_equals_reference(n, total, ema):
    ops = _script(np.random.default_rng(n * total), n, total, ema, 40)
    assert _run_straggler(tst, n, total, ema, ops) == _run_straggler(jst, n, total, ema, ops)


def test_straggler_planner_properties():
    """tests/test_dist.py's straggler cases on the port."""
    p = tst.StragglerPlanner(n_shards=4, total_microbatches=32)
    plan = p.plan()
    assert plan.sum() == 32 and (plan == 8).all()
    p.observe(np.array([1.0, 1.0, 1.0, 4.0]) * plan, plan)
    plan2 = p.plan()
    assert plan2.sum() == 32 and plan2[3] < 8
    assert p.expected_makespan(plan2) < p.expected_makespan(plan) * 0.95
    p = tst.StragglerPlanner(n_shards=3, total_microbatches=9)
    p.deactivate(0)
    p.deactivate(2)
    assert p.plan().tolist() == [0, 9, 0]
    with pytest.raises(ValueError, match="last active"):
        p.deactivate(1)
    with pytest.raises(ValueError, match="shard 7 out of range"):
        p.deactivate(7)
    with pytest.raises(ValueError, match="one entry per shard"):
        p.observe([1.0], [1])
    for mod in (tst, jst):
        with pytest.raises(ValueError, match="at least one micro-batch"):
            mod.StragglerPlanner(n_shards=4, total_microbatches=3)
