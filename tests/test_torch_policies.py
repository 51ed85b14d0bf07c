"""The port's policy API against ``repro.sched``.

- Registry: the built-in names (``random``, ``locality``, ``priority``
  and ``wfq`` beside the paper's four), duplicate and overwritten
  registrations, the decorator form and ``unregister``, typed query
  strings and loud errors (``tests/test_sched_api.py:98-170``).
- ``assign_from_scores`` on the reference's cases (``:264-285``) and on
  seeded matrices against the reference's function.
- Simulations: every policy's fingerprint equals ``repro``'s numpy path on
  the inputs of ``tests/test_sched_api.py:286-361`` and over the NT 6
  matrix of ``tests/test_torch_sim.py`` ({cholesky, lu, qr} × {0, 3, 8}
  GPUs × seeds {0, 7}), activations scored by the backend
  (``min_wide=1``) and on the host (``min_wide`` above every activation).
- The score matrices of every policy, HEFT's and DADA's views included,
  equal the reference's entry for entry.
- Two tenants submitted at priorities 1 and 2 under ``priority`` and
  ``wfq``: per-graph results equal the reference's, and so do WFQ's
  virtual times, unretired as in the reference's default loop.
- Audited policy runs give the reference's JSONL line for line and verify
  clean.

Every seed is fixed: nothing is drawn by hypothesis.
"""
import numpy as np
import pytest

from repro.configs.paper_machine import paper_machine as ref_paper_machine
from repro.core.simulator import Simulator as RefSimulator
from repro.linalg.cholesky import cholesky_graph as ref_cholesky_graph
from repro.linalg.lu import lu_graph as ref_lu_graph
from repro.linalg.qr import qr_graph as ref_qr_graph
from repro.runtime import Engine as RefEngine
from repro.sched import assign_from_scores as ref_assign_from_scores
from repro.sched import resolve as ref_resolve
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.core import Simulator
from repro_torch.linalg.cholesky import cholesky_graph
from repro_torch.linalg.lu import lu_graph
from repro_torch.linalg.qr import qr_graph
from repro_torch.runtime import Engine
from repro_torch.sched import (
    LocalityPolicy,
    Policy,
    RandomPolicy,
    ScoreMatrixPolicy,
    assign_from_scores,
    get_factory,
    register,
    registered,
    resolve,
    unregister,
)
from repro_torch.verify import errors, verify_audit

KERNELS = {
    "cholesky": (ref_cholesky_graph, cholesky_graph),
    "lu": (ref_lu_graph, lu_graph),
    "qr": (ref_qr_graph, qr_graph),
}
POLICIES = ("random", "random?seed=11", "locality", "priority", "wfq")
SCORED = ("locality", "priority", "wfq")  # the policies that take a device


def _fingerprint(res):
    return (
        res.makespan,
        res.total_bytes,
        res.n_transfers,
        res.n_steals,
        tuple(sorted(res.busy.items())),
        tuple((iv.tid, iv.rid, iv.start, iv.end) for iv in res.intervals),
    )


def port_policy(spec, **kw):
    """The port's policy for the CPU (``random`` and ``ws`` take no device)."""
    return resolve(spec) if spec.startswith(("random", "ws")) else resolve(spec, device="cpu", **kw)


def ref_policy(spec):
    if spec in ("heft", "dada", "dual") or spec.startswith("dada"):
        return ref_resolve(spec, backend="numpy")
    return ref_resolve(spec)


def _pair(kernel, spec, n_gpus, seed, nt=6, tile=256, **kw):
    ref_build, build = KERNELS[kernel]
    a = RefSimulator(ref_build(nt, tile, with_fns=False), ref_paper_machine(n_gpus),
                     ref_policy(spec), seed=seed)
    b = Simulator(build(nt, tile), paper_machine(n_gpus), port_policy(spec, **kw), seed=seed)
    return a.run(), b.run()


# ---------------------------------------------------------------------------
# registry


def test_registered_names_include_builtins():
    names = registered()
    for expected in ("heft", "dada", "dual", "ws", "random", "locality", "priority", "wfq"):
        assert expected in names


def test_duplicate_registration_rejected():
    with pytest.raises(ValueError, match="already registered"):
        register("heft", lambda: None)

    class Fake:
        name = "fake-heft"

    original = get_factory("heft")
    try:
        register("heft", Fake, overwrite=True)
        assert get_factory("heft") is Fake
    finally:
        register("heft", original, overwrite=True)
    assert get_factory("heft") is original


def test_register_decorator_and_unregister():
    @register("test-custom-policy")
    class Custom:
        name = "custom"

    try:
        assert "test-custom-policy" in registered()
        assert isinstance(resolve("test-custom-policy"), Custom)
    finally:
        unregister("test-custom-policy")
    assert "test-custom-policy" not in registered()
    with pytest.raises(ValueError, match="unknown policy"):
        resolve("test-custom-policy")
    unregister("test-custom-policy")  # unregistering twice is a no-op


def test_query_string_kwargs_parsed_and_typed():
    s = resolve("dada?alpha=0.25&use_cp=1&max_iters=12&affinity=all_resident", device="cpu")
    assert s.alpha == 0.25 and isinstance(s.alpha, float)
    assert s.use_cp is True
    assert s.max_iters == 12 and isinstance(s.max_iters, int)
    assert s.affinity_name == "all_resident"
    assert resolve("dada?use_cp=false", device="cpu").use_cp is False
    s3 = resolve("random?seed=9")
    assert s3.seed == 9 and isinstance(s3.seed, int) and s3.name == "random(9)"
    s4 = resolve("wfq?min_wide=32", device="cpu")
    assert s4.min_wide == 32 and s4.name == "wfq"


def test_query_string_errors_are_loud():
    with pytest.raises(ValueError, match="not a number"):
        resolve("dada?alpha=banana", device="cpu")
    with pytest.raises(ValueError, match="not a boolean"):
        resolve("dada?use_cp=maybe", device="cpu")
    with pytest.raises(ValueError, match="unknown parameter"):
        resolve("dada?frobnicate=1", device="cpu")
    with pytest.raises(ValueError, match="unknown parameter"):
        resolve("random?device=cpu")  # random scores nothing and takes no device
    with pytest.raises(ValueError, match="unknown policy"):
        resolve("does-not-exist")
    with pytest.raises(ValueError, match="min_wide"):
        resolve("locality?min_wide=0", device="cpu")


def test_resolve_passes_policies_through():
    s = resolve("heft", device="cpu")
    assert resolve(s) is s


@pytest.mark.parametrize("spec", ["heft", "dada", "dual", "ws", "random", "locality",
                                  "priority", "wfq"])
def test_policies_satisfy_protocol(spec):
    assert isinstance(port_policy(spec), Policy)


# ---------------------------------------------------------------------------
# assign_from_scores


def test_assign_from_scores_basic_and_capacity():
    scores = np.array([[0.0, 1.0], [0.0, 1.0], [0.0, 1.0], [0.0, 1.0]])
    assert assign_from_scores(scores).tolist() == [0, 0, 0, 0]
    choice = assign_from_scores(scores, capacity=[2, 2])
    assert sorted(choice.tolist()) == [0, 0, 1, 1]
    with pytest.raises(ValueError, match="no eligible column"):
        assign_from_scores(scores, capacity=[1, 1])
    with pytest.raises(ValueError, match="return_loads requires loads"):
        assign_from_scores(scores, return_loads=True)


def test_assign_from_scores_load_aware():
    scores = np.zeros((4, 2))
    costs = np.full((4, 2), 3.0)
    choice, loads = assign_from_scores(scores, loads=[0.0, 1.0], costs=costs, return_loads=True)
    assert choice.tolist() == [0, 1, 0, 1]
    assert loads.tolist() == [6.0, 7.0]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_assign_from_scores_equals_reference(seed):
    """Seeded matrices with ties (a 1/4 grid), loads, costs, capacities
    and an order: the same choices and loads, bit for bit."""
    rng = np.random.default_rng(seed)
    n, m = 12, 5
    scores = np.floor(rng.random((n, m)) * 4) / 4
    loads = rng.random(m)
    costs = rng.random((n, m))
    capacity = rng.integers(2, 5, size=m)
    order = rng.permutation(n).tolist()
    for kw in ({}, dict(loads=loads), dict(loads=loads, costs=costs),
               dict(capacity=capacity, order=order), dict(loads=loads, costs=costs, order=order)):
        assert (assign_from_scores(scores, **kw) == ref_assign_from_scores(scores, **kw)).all()
    got = assign_from_scores(scores, loads=loads, costs=costs, return_loads=True)
    want = ref_assign_from_scores(scores, loads=loads, costs=costs, return_loads=True)
    assert got[0].tolist() == want[0].tolist() and got[1].tolist() == want[1].tolist()


# ---------------------------------------------------------------------------
# simulations against the reference


@pytest.mark.parametrize("spec", POLICIES)
def test_policies_equal_reference_on_sched_api_inputs(spec):
    """tests/test_sched_api.py's determinism case: Cholesky NT 6 on four
    GPUs at seed 3, twice, equal to each other and to the reference."""
    runs = [
        Simulator(cholesky_graph(6, 256), paper_machine(4), port_policy(spec), seed=3).run()
        for _ in range(2)
    ]
    ref = RefSimulator(ref_cholesky_graph(6, 256, with_fns=False), ref_paper_machine(4),
                       ref_policy(spec), seed=3).run()
    assert _fingerprint(runs[0]) == _fingerprint(runs[1]) == _fingerprint(ref)
    assert runs[0].makespan > 0 and runs[0].strategy == ref.strategy


def test_random_policies_differ_across_policy_seeds():
    a = Simulator(cholesky_graph(6, 256), paper_machine(4), resolve("random?seed=1"), seed=0).run()
    b = Simulator(cholesky_graph(6, 256), paper_machine(4), resolve("random?seed=2"), seed=0).run()
    assert _fingerprint(a) != _fingerprint(b)


def test_random_policy_uses_every_resource_eventually():
    machine = paper_machine(4)
    res = Simulator(cholesky_graph(8, 256), machine, RandomPolicy(seed=0), seed=0).run()
    ref = RefSimulator(ref_cholesky_graph(8, 256, with_fns=False), ref_paper_machine(4),
                       ref_resolve("random"), seed=0).run()
    assert {iv.rid for iv in res.intervals} == {r.rid for r in machine.resources}
    assert _fingerprint(res) == _fingerprint(ref)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n_gpus", [0, 3, 8])
@pytest.mark.parametrize("spec", ["random", "locality", "priority", "wfq"])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_policy_matches_reference(kernel, spec, n_gpus, seed):
    a, b = _pair(kernel, spec, n_gpus, seed)
    assert _fingerprint(b) == _fingerprint(a)
    assert (b.strategy, b.n_events, b.total_flops) == (a.strategy, a.n_events, a.total_flops)


@pytest.mark.parametrize("min_wide", [4, 10**9])
@pytest.mark.parametrize("spec", SCORED)
def test_policy_host_path_and_mixed_widths(spec, min_wide):
    """min_wide above some (or every) activation: the host rows score
    those activations, and the result does not change."""
    a, b = _pair("qr", spec, 8, 4, nt=7, min_wide=min_wide)
    assert _fingerprint(b) == _fingerprint(a)


def _primed(pkg, spec, graph, machine):
    """A simulator with some data on device memories, and its policy."""
    strat = ref_policy(spec) if pkg == "ref" else port_policy(spec)
    sim = (RefSimulator if pkg == "ref" else Simulator)(graph, machine, strat, seed=0)
    strat.init(sim)
    for k, name in enumerate(sim.arrays.data_names):
        if k % 3 == 0:
            sim.residency.write(name, (k // 3) % 4 - 1)
    sim.load_ts[:] = [0.001 * (j % 4) for j in range(len(sim.load_ts))]
    return sim, strat


@pytest.mark.parametrize("spec", ["heft", "dada?use_cp=1", "dada?alpha=0.5", "locality",
                                  "priority", "wfq", "random"])
def test_score_matrix_equals_reference(spec):
    """Every policy's (ready × resources) matrix on the first wide wave of
    a primed Cholesky NT 5 run, entry for entry."""
    got = {}
    for pkg, build, machine in (("ref", ref_cholesky_graph, ref_paper_machine(3)),
                                ("port", cholesky_graph, paper_machine(3))):
        graph = build(5, 256, with_fns=False)
        sim, strat = _primed(pkg, spec, graph, machine)
        ready = [graph.tasks[t] for t in range(0, len(graph), 3)]
        got[pkg] = strat.score_matrix(sim, ready)
    assert got["port"].shape == (len(ready), len(paper_machine(3).resources))
    assert np.isfinite(got["port"]).all()
    assert got["port"].tolist() == got["ref"].tolist()


def test_ws_has_no_score_matrix():
    graph = cholesky_graph(5, 256)
    ws = resolve("ws")
    sim = Simulator(graph, paper_machine(3), ws, seed=0)
    assert ws.score_matrix(sim, graph.roots()) is None


def test_locality_prefers_resident_data():
    """A task whose inputs sit on one GPU memory scores that GPU strictly
    cheaper than the other accelerators."""
    machine = paper_machine(4)
    graph = cholesky_graph(5, 256)
    strat = LocalityPolicy(device="cpu")
    sim = Simulator(graph, machine, strat, seed=0)
    gpu = machine.gpus[0]
    root = graph.roots()[0]
    for _, name, _size in sim.arrays.task_reads[root.tid]:
        sim.residency.write(name, gpu.mem)
    S = strat.score_matrix(sim, [root])
    j_gpu = [i for i, r in enumerate(machine.resources) if r.rid == gpu.rid][0]
    others = [i for i, r in enumerate(machine.resources) if r.is_accelerator and r.rid != gpu.rid]
    assert all(S[0, j_gpu] < S[0, j] for j in others)


def test_pressure_matrix_none_when_unbounded():
    sim = Simulator(cholesky_graph(4, 256), paper_machine(2), resolve("locality", device="cpu"),
                    seed=0)
    assert ScoreMatrixPolicy.pressure_matrix(sim.strategy, sim, sim.graph.roots()) is None


# ---------------------------------------------------------------------------
# tenants


def _tenants(pkg, spec, priorities, n_gpus=3, seed=5, **kw):
    if pkg == "ref":
        eng = RefEngine(ref_paper_machine(n_gpus), ref_policy(spec), seed=seed, **kw)
        graphs = (ref_cholesky_graph(6, 256, with_fns=False), ref_lu_graph(5, 256, with_fns=False))
    else:
        eng = Engine(paper_machine(n_gpus), port_policy(spec), seed=seed, **kw)
        graphs = (cholesky_graph(6, 256), lu_graph(5, 256))
    for g, p in zip(graphs, priorities):
        eng.submit(g, priority=p)
    return eng, eng.run()


@pytest.mark.parametrize("priorities", [(1.0, 2.0), (2.0, 1.0), (1.0, 1.0), (3.0, 0.5)])
@pytest.mark.parametrize("spec", ["priority", "wfq", "locality"])
def test_two_tenants_equal_reference(spec, priorities):
    ref, ref_res = _tenants("ref", spec, priorities)
    eng, res = _tenants("port", spec, priorities)
    assert [_fingerprint(r) for r in res] == [_fingerprint(r) for r in ref_res]
    assert [c.priority for c in eng._ctxs] == list(priorities)
    if spec == "wfq":
        # the virtual times, in the reference's insertion order, unretired
        assert list(eng.strategy._vt.items()) == list(ref.strategy._vt.items())
        assert sorted(eng.strategy._vt) == [0, 1]


def test_priority_biases_the_choice():
    """A tenant's priority divides the backlog it perceives: raising the
    second tenant's priority moves its placements."""
    eng, even = _tenants("port", "priority", (1.0, 1.0))
    eng2, boosted = _tenants("port", "priority", (1.0, 2.0))
    assert [eng2.strategy.tenant_scale(eng2, c) for c in eng2._ctxs] == [1.0, 0.5]
    assert _fingerprint(boosted[1]) != _fingerprint(even[1])


@pytest.mark.parametrize("priority", [0.0, -1.0, float("nan")])
def test_submit_rejects_a_priority_not_above_zero(priority):
    eng = Engine(paper_machine(2), port_policy("wfq"), seed=0)
    with pytest.raises(ValueError, match="priority must be > 0"):
        eng.submit(cholesky_graph(4, 256), priority=priority)


# ---------------------------------------------------------------------------
# audit


@pytest.mark.parametrize("spec", ["random", "locality", "priority", "wfq"])
@pytest.mark.parametrize("kernel", ["cholesky", "qr"])
def test_policy_audit_log_equals_reference(kernel, spec, tmp_path):
    ref_build, build = KERNELS[kernel]
    ref = RefSimulator(ref_build(6, 256, with_fns=False), ref_paper_machine(3), ref_policy(spec),
                       seed=7, audit=True)
    port = Simulator(build(6, 256), paper_machine(3), port_policy(spec), seed=7, audit=True)
    ref.run(), port.run()
    ref.audit.to_jsonl(str(tmp_path / "ref.jsonl"))
    port.audit.to_jsonl(str(tmp_path / "port.jsonl"))
    want = (tmp_path / "ref.jsonl").read_text().splitlines()
    got = (tmp_path / "port.jsonl").read_text().splitlines()
    assert got == want
    assert errors(verify_audit(port.audit)) == []
