"""The port's capacity-bounded memories against ``repro.runtime.memory``.

- Configuration: a capacity below one task's working set raises at
  construction, an unknown eviction policy is rejected
  (``tests/test_runtime.py:221-234``); an unbounded engine is inert (no
  observer, no memory wired into the transfers).
- The pressure signal: ``predicted_eviction_bytes``, ``pressure_rows`` on
  a crowded memory (``:256-277``) and the pressure fold of HEFT and
  DADA+CP on a wide wave under 4 MB (``:373``) equal the reference's, the
  fold through the scorer's ``x_bias`` on the CPU backend.
- Bounded runs: fingerprint, ``n_evictions``, ``n_writebacks``,
  ``writeback_bytes`` and ``max_resident`` equal the reference's over
  {cholesky, lu, qr} × {heft, dada(0.5)+cp, locality, priority} × {LRU,
  affinity}, on ``:279-294``'s case and on the verifier's cases
  (``tests/test_verify_schedule.py:58-64``, ``:158``), whose audit logs
  equal the reference's JSONL line for line and verify clean.
- The property test ``tests/test_residency_property.py:266-298`` at a
  fixed list of seeds that includes 28 and 3201; at those two both
  packages raise the same error (the port's message names
  ``mem_capacity`` where the reference names its environment variable).
- C7: ``capacity_sweep``'s rows equal the reference's, every run verified.

Every seed is fixed: nothing is drawn by hypothesis.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.configs.paper_machine import paper_machine as ref_paper_machine
from repro.core import DataObject as RefDataObject
from repro.core import Mode as RefMode
from repro.core import TaskGraph as RefTaskGraph
from repro.core.simulator import Simulator as RefSimulator
from repro.linalg.cholesky import cholesky_graph as ref_cholesky_graph
from repro.linalg.lu import lu_graph as ref_lu_graph
from repro.linalg.qr import qr_graph as ref_qr_graph
from repro.runtime import predicted_eviction_bytes as ref_predicted_eviction_bytes
from repro.sched import resolve as ref_resolve
from repro_torch.bench import paper_validation as pv
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.convert import graph_from_spec, machine_from_spec
from repro_torch.core import DataObject, Mode, Simulator, TaskGraph
from repro_torch.linalg.cholesky import cholesky_graph
from repro_torch.linalg.lu import lu_graph
from repro_torch.linalg.qr import qr_graph
from repro_torch.runtime.memory import predicted_eviction_bytes, pressure_rows_for
from repro_torch.sched import resolve
from repro_torch.verify import errors, verify_audit
from test_torch_sim import _random_graph, graph_spec, machine_spec

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import paper_validation as ref_pv  # noqa: E402

MB = 1024 * 1024
KERNELS = {
    "cholesky": (ref_cholesky_graph, cholesky_graph),
    "lu": (ref_lu_graph, lu_graph),
    "qr": (ref_qr_graph, qr_graph),
}
SPECS = ("heft", "dada?alpha=0.5&use_cp=1", "locality", "priority")
# the seeds of the property test: 28 and 3201 are where the reference's
# hypothesis draws have failed it (a working set that cannot fit)
PROPERTY_SEEDS = (0, 3, 28, 77, 1234, 3201, 9999)
RAISING = {  # (seed, eviction, spec) whose run raises, in both packages
    (28, "lru", "dada?alpha=0.5&use_cp=1"), (28, "affinity", "dada?alpha=0.5&use_cp=1"),
    (3201, "lru", "heft"), (3201, "lru", "dada?alpha=0.5&use_cp=1"),
    (3201, "affinity", "heft"), (3201, "affinity", "dada?alpha=0.5&use_cp=1"),
}


def ref_policy(spec):
    return ref_resolve(spec, backend="numpy") if spec.startswith(("heft", "dada")) else (
        ref_resolve(spec))


def port_policy(spec):
    return resolve(spec) if spec in ("ws", "random") else resolve(spec, device="cpu")


def _fp(sim, res):
    """The result plus the memory's counters."""
    m = sim.metrics
    return (
        res.makespan, res.total_bytes, res.n_transfers, tuple(sorted(res.busy.items())),
        tuple((iv.tid, iv.rid, iv.start, iv.end) for iv in res.intervals),
        m.n_evictions, m.n_writebacks, m.writeback_bytes,
        tuple(sorted(sim.memory.max_resident.items())),
    )


def _pair(kernel, spec, n_gpus, nt, tile, seed=0, audit=False, **kw):
    ref_build, build = KERNELS[kernel]
    ref = RefSimulator(ref_build(nt, tile, with_fns=False), ref_paper_machine(n_gpus),
                       ref_policy(spec), seed=seed, audit=audit, **kw)
    port = Simulator(build(nt, tile), paper_machine(n_gpus), port_policy(spec), seed=seed,
                     audit=audit, **kw)
    return ref, ref.run(), port, port.run()


# ---------------------------------------------------------------------------
# configuration


def test_capacity_too_small_for_one_task_rejected():
    g = TaskGraph()
    g.add_task("big", [(DataObject("x", 100 * MB), Mode.RW)], flops=1e9)
    with pytest.raises(ValueError, match="working set"):
        Simulator(g, paper_machine(1), resolve("heft", device="cpu"), mem_capacity=MB)
    ref_g = RefTaskGraph()
    ref_g.add_task("big", [(RefDataObject("x", 100 * MB), RefMode.RW)], flops=1e9)
    with pytest.raises(ValueError, match="working set") as ref_err:
        RefSimulator(ref_g, ref_paper_machine(1), ref_policy("heft"), mem_capacity=MB)
    assert "(104857600 B)" in str(ref_err.value)


def test_unknown_eviction_policy_rejected():
    with pytest.raises(ValueError, match="eviction"):
        Simulator(cholesky_graph(4, 256), paper_machine(1), resolve("heft", device="cpu"),
                  mem_capacity=64 * MB, eviction="random")


def test_unbounded_engine_is_inert():
    sim = Simulator(cholesky_graph(4, 256), paper_machine(2), resolve("heft", device="cpu"))
    assert not sim.memory.bounded and sim.transfers.memory is None
    assert sim.residency.observer is None
    res = sim.run()
    assert (sim.metrics.n_evictions, sim.metrics.n_writebacks, sim.metrics.writeback_bytes) == (
        0, 0, 0)
    assert all(w.pins is None for w in sim.workers) and res.makespan > 0


def test_bounded_engine_wires_the_memory():
    sim = Simulator(cholesky_graph(4, 256), paper_machine(2), resolve("heft", device="cpu"),
                    mem_capacity=64 * MB, eviction="affinity")
    assert sim.memory.bounded and sim.memory.capacity == 64 * MB
    assert sim.memory.policy == "affinity" and sim.transfers.memory is sim.memory
    assert sim.residency.observer is not None


# ---------------------------------------------------------------------------
# the pressure signal


def test_predicted_eviction_bytes_formula():
    args = (np.array([0.0, 50.0, 120.0]), np.array([30.0, 80.0, 10.0]), 100.0)
    assert predicted_eviction_bytes(*args).tolist() == [0.0, 30.0, 10.0]
    assert predicted_eviction_bytes(*args).tolist() == ref_predicted_eviction_bytes(*args).tolist()


def test_pressure_rows_on_crowded_memory_equal_reference():
    rows = {}
    for pkg in ("ref", "port"):
        if pkg == "ref":
            sim = RefSimulator(ref_cholesky_graph(8, 512, with_fns=False), ref_paper_machine(2),
                               ref_resolve("locality"), seed=0, mem_capacity=8 * MB)
        else:
            sim = Simulator(cholesky_graph(8, 512), paper_machine(2),
                            resolve("locality", device="cpu"), seed=0, mem_capacity=8 * MB)
        for name in sim.arrays.data_names[-4:]:  # 4 x 2 MB tiles fill GPU memory 0
            sim.residency.add_copy(name, 0)
        tids = [t.tid for t in sim.graph.tasks[:5]]
        mems = [r.mem for r in sim.machine.resources]
        rows[pkg] = sim.memory.pressure_rows(sim.arrays, tids, mems, sim.residency,
                                             sim.transfer_model)
    got, mems = rows["port"], [r.mem for r in paper_machine(2).resources]
    assert got.tolist() == rows["ref"].tolist()
    assert (got[:, mems.index(-1)] == 0.0).all() and got[:, mems.index(0)].max() > 0.0
    assert (got[:, mems.index(1)] <= got[:, mems.index(0)]).all()


def _wide_wave(graph):
    depth = [0] * len(graph)
    for t in graph.tasks:
        preds = graph.pred[t.tid]
        depth[t.tid] = (max(depth[p] for p in preds) + 1) if preds else 0
    counts = {}
    for d in depth:
        counts[d] = counts.get(d, 0) + 1
    best = max(counts, key=lambda d: (counts[d], -d))
    return [t for t in graph.tasks if depth[t.tid] == best]


@pytest.mark.parametrize("every", [3, 1])
@pytest.mark.parametrize("min_wide", [1, 10**9])
@pytest.mark.parametrize("spec", ["dada?alpha=0.5&use_cp=1", "heft"])
def test_pressure_fold_on_a_wide_wave_equals_reference(spec, min_wide, every):
    """tests/test_runtime.py:373's case: one placement of a ≥ 32-wide wave
    under 4 MB with every third datum (as there) or every datum spread over
    the GPUs (every memory past its capacity: the penalty is positive).
    The fold goes through the scorer's x_bias (min_wide 1) or
    fold_pressure on the host rows (min_wide above the wave), and places
    as the reference's numpy path does."""
    placements = {}
    for pkg in ("ref", "port"):
        graph = (ref_cholesky_graph(10, 256, with_fns=False) if pkg == "ref"
                 else cholesky_graph(10, 256))
        wave = _wide_wave(graph)
        assert len(wave) >= 32
        if pkg == "ref":
            strat = ref_policy(spec)
            sim = RefSimulator(graph, ref_paper_machine(4), strat, seed=0, mem_capacity=4 * MB,
                               eviction="affinity")
        else:
            strat = resolve(spec, device="cpu", min_wide=min_wide)
            sim = Simulator(graph, paper_machine(4), strat, seed=0, mem_capacity=4 * MB,
                            eviction="affinity")
        for k, name in enumerate(sim.arrays.data_names):
            if k % every == 0:
                sim.residency.write(name, k % 4)
        placed = {}
        sim.push = lambda task, rid, _p=placed: _p.__setitem__(task.tid, rid)
        strat.place(sim, wave, None)
        placements[pkg] = (placed, list(sim.load_ts))
    assert placements["port"] == placements["ref"]
    P = pressure_rows_for(sim, [t.tid for t in wave], sim.machine.resources)
    assert P is not None and (P.max() > 0.0) == (every == 1)


# ---------------------------------------------------------------------------
# bounded runs


@pytest.mark.parametrize("cap,eviction", [(12 * MB, "lru"), (16 * MB, "affinity")])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_bounded_run_equals_reference(kernel, spec, cap, eviction):
    ref, a, port, b = _pair(kernel, spec, 4, 8, 512, seed=1, mem_capacity=cap, eviction=eviction)
    assert _fp(port, b) == _fp(ref, a)
    assert port.metrics.n_evictions > 0
    assert all(high <= cap for high in port.memory.max_resident.values())


def test_pressure_changes_placements_under_capacity():
    """tests/test_runtime.py:279-294: HEFT on Cholesky NT 12 at 24 MB
    places otherwise than unbounded; both equal the reference's."""
    out = {}
    for cap in (0, 24 * MB):
        ref, a, port, b = _pair("cholesky", "heft", 4, 12, 512, noise=0.0, mem_capacity=cap)
        assert _fp(port, b) == _fp(ref, a)
        out[cap] = [(iv.tid, iv.rid) for iv in b.intervals]
    assert sorted(t for t, _ in out[24 * MB]) == sorted(t for t, _ in out[0])
    assert out[24 * MB] != out[0]


def _jsonl(log, path):
    log.to_jsonl(str(path))
    return path.read_text().splitlines()


@pytest.mark.parametrize("spec,nt,cap,eviction", [
    ("dada?alpha=0.5&use_cp=1", 10, 64 * MB, "affinity"),  # test_verify_schedule.py:58-64
    ("dada?alpha=0.5&use_cp=1", 10, 32 * MB, "lru"),
    ("dada?alpha=0.5&use_cp=1", 8, 64 * MB, "affinity"),  # :158, without the faults
    ("heft", 10, 32 * MB, "lru"),
    ("locality", 10, 32 * MB, "affinity"),
    ("wfq", 10, 32 * MB, "lru"),
])
def test_bounded_audit_log_equals_reference(spec, nt, cap, eviction, tmp_path):
    ref, a, port, b = _pair("cholesky", spec, 4, nt, 256, noise=0.0, audit=True,
                            mem_capacity=cap, eviction=eviction)
    assert _fp(port, b) == _fp(ref, a)
    got = _jsonl(port.audit, tmp_path / "port.jsonl")
    assert got == _jsonl(ref.audit, tmp_path / "ref.jsonl")
    assert port.audit.machine["capacity"] == cap and port.audit.machine["eviction"] == eviction
    assert errors(verify_audit(port.audit)) == []


def test_bounded_audit_log_records_evictions(tmp_path):
    """A tight capacity: evictions and write-backs land in the log, ahead
    of the execution record whose writes forced them, as in the
    reference."""
    ref, a, port, b = _pair("lu", "heft", 4, 8, 512, seed=2, audit=True, mem_capacity=12 * MB,
                            eviction="lru")
    log = port.audit
    assert log.evictions and any(e.dirty for e in log.evictions)
    assert sum(h.kind == "writeback" for h in log.hops) == port.metrics.n_writebacks
    assert _jsonl(log, tmp_path / "port.jsonl") == _jsonl(ref.audit, tmp_path / "ref.jsonl")
    assert errors(verify_audit(log)) == []


# ---------------------------------------------------------------------------
# the property test, at fixed seeds


def _property_run(pkg, seed, eviction, spec):
    g = _random_graph(seed)
    if pkg == "ref":
        sim = RefSimulator(g, ref_paper_machine(3), ref_resolve(spec), seed=seed,
                           mem_capacity=500_000, eviction=eviction)
    else:
        sim = Simulator(graph_from_spec(graph_spec(g)), machine_from_spec(
            machine_spec(ref_paper_machine(3))), port_policy(spec), seed=seed,
            mem_capacity=500_000, eviction=eviction)
    return sim, sim.run()


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "locality"])
@pytest.mark.parametrize("eviction", ["lru", "affinity"])
@pytest.mark.parametrize("seed", PROPERTY_SEEDS)
def test_capacity_property_at_fixed_seeds(seed, eviction, spec):
    """The body of test_capacity_never_exceeded_and_dirty_written_back on
    both packages: the same run, or the same error."""
    if (seed, eviction, spec) in RAISING:
        with pytest.raises(RuntimeError) as ref_err:
            _property_run("ref", seed, eviction, spec)
        with pytest.raises(RuntimeError) as err:
            _property_run("port", seed, eviction, spec)
        want = str(ref_err.value).replace("REPRO_SCHED_MEM_CAPACITY", "mem_capacity")
        assert str(err.value) == want and "over capacity" in want
        return
    ref, a = _property_run("ref", seed, eviction, spec)
    sim, res = _property_run("port", seed, eviction, spec)
    assert _fp(sim, res) == _fp(ref, a)
    assert sorted(iv.tid for iv in res.intervals) == list(range(len(sim.graph)))
    for high in sim.memory.max_resident.values():
        assert high <= 500_000
    for name in sim.arrays.data_names:
        assert sim.residency.has_any(name)
    if sim.metrics.n_writebacks:
        assert 0 < sim.metrics.writeback_bytes <= res.total_bytes


# ---------------------------------------------------------------------------
# C7


def test_capacity_sweep_equals_reference():
    rows = pv.capacity_sweep(device="cpu")
    want = ref_pv.capacity_sweep()
    assert [{k: v for k, v in r.items() if not k.endswith("_verify_errors")} for r in rows] == want
    assert all(r["heft_verify_errors"] == r["dada_verify_errors"] == 0 for r in rows)
    assert [r["capacity"] for r in rows] == [0, 128 * MB, 64 * MB, 32 * MB]


def test_c7_claim(monkeypatch):
    rows = pv.capacity_sweep(device="cpu")
    check = pv.check_c7("cpu", rows=rows)
    assert check["passed"] and check["claim"].startswith("C7 ")
    assert "verifier errors 0" in check["measured"]
    # a verifier error, or a shrinking gap, fails it
    bad = [dict(r) for r in rows]
    bad[1]["dada_verify_errors"] = 1
    assert not pv.check_c7("cpu", rows=bad)["passed"]
    bad = [dict(r) for r in rows]
    bad[-1]["gap"] = bad[-2]["gap"] - 1
    assert not pv.check_c7("cpu", rows=bad)["passed"]
    monkeypatch.setattr(pv, "capacity_sweep", lambda device: rows)
    assert pv.check_c7("cpu") == check  # without rows it runs the sweep
