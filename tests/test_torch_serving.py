"""The port's serving simulator against ``repro``'s: arrival streams and
traces, streamed tenants in the classic loop, admission control, the
serving pool with incremental rescoring, stale-transfer cancellation, the
serving aggregates and the two benchmarks built on them.

Each case runs the reference (its numpy path) and the port
(``device="cpu"``: the scorer's plain version over the same packed
buffer) on the same inputs and holds the port to the reference field for
field, floats exact: every interval of every tenant, the per-tenant rows,
``serving_report``, ``n_events``, ``rows_built``, the metrics counters and
the audit JSONL line for line. Every seed is fixed; nothing here sets an
environment variable except through ``monkeypatch`` (the reference's C9
run reads ``REPRO_BENCH_FAST``; the port has no such knob).
"""
import json
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.paper_machine import paper_machine as ref_paper_machine
from repro.core import DataObject as RefDataObject
from repro.core import Mode as RefMode
from repro.core import TaskGraph as RefTaskGraph
from repro.core.simulator import Simulator as RefSimulator
from repro.linalg.cholesky import cholesky_graph as ref_cholesky_graph
from repro.linalg.lu import lu_graph as ref_lu_graph
from repro.linalg.qr import qr_graph as ref_qr_graph
from repro.runtime import load as ref_load
from repro.runtime.engine import Engine as RefEngine
from repro.runtime.metrics import jain_fairness as ref_jain
from repro.runtime.metrics import percentile as ref_percentile
from repro.runtime.metrics import serving_report as ref_serving_report
from repro.sched import resolve as ref_resolve
from repro.sched.policies import WFQPolicy as RefWFQ
from repro_torch.bench import scenario_matrix as sm
from repro_torch.bench import serving_load as sl
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.convert import graph_from_spec
from repro_torch.core import DataObject, Mode, Simulator, TaskGraph
from repro_torch.core.backend import TorchScoringBackend
from repro_torch.linalg.cholesky import cholesky_graph
from repro_torch.linalg.lu import lu_graph
from repro_torch.linalg.qr import qr_graph
from repro_torch.runtime import load
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.metrics import jain_fairness, percentile, serving_report
from repro_torch.runtime.rescore import ServingScheduler
from repro_torch.sched import resolve
from repro_torch.sched.policies import WFQPolicy
from repro_torch.verify import errors, verify_audit
from test_torch_sim import _random_graph, graph_spec

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import scenario_matrix as ref_sm  # noqa: E402
from benchmarks import serving_load as ref_sl  # noqa: E402

MB = 1024 * 1024
PROCESSES = ("poisson", "bursty", "diurnal")
SPECS = ("heft", "dada?alpha=0.5&use_cp=1", "wfq")
SEEDS = (0, 1, 12345)


def ref_policy(spec):
    name = spec.split("?")[0]
    return ref_resolve(spec, backend="numpy") if name in ("heft", "dada", "dual") else (
        ref_resolve(spec))


def port_policy(spec):
    return resolve(spec) if spec.split("?")[0] in ("ws", "random") else resolve(spec, device="cpu")


def _arr(a):
    return (a.t, a.kind, a.tenant, a.priority)


def _res(r):
    return (r.makespan, r.total_bytes, r.n_transfers, r.n_steals, tuple(sorted(r.busy.items())),
            tuple((iv.tid, iv.rid, iv.start, iv.end) for iv in r.intervals), r.strategy,
            r.total_flops, r.n_events, r.faults, r.submit_at, r.admit_at, r.admitted)


def _metrics(m):
    return {k: getattr(m, k) for k in type(m).__slots__ if k != "intervals"}


def _engine_fp(e):
    """Everything a run left in its engine: every tenant's intervals and
    arrival state, the machine-global counters and, in serving mode, the
    pool's rounds and rows."""
    ctxs = [(c.gid, c.submit_at, c.finish, c.n_done, c.arrived, c.admitted, c.rejected,
             c.admit_at, tuple((iv.tid, iv.rid, iv.start, iv.end) for iv in c.intervals))
            for c in e._ctxs]
    pool = None if e._serving is None else (e._serving.n_rounds, e._serving.rows_built)
    return ctxs, _metrics(e.metrics), e.now, pool, e._active_ws


def _serving_fp(out):
    keys = ("tenants", "report", "n_events", "n_arrivals", "n_admitted", "n_rejected",
            "n_deferred", "rows_built")
    return ({k: out[k] for k in keys}, [_res(r) for r in out["results"]], _engine_fp(out["engine"]))


# ---------------------------------------------------------------------------
# arrival streams and traces


@pytest.mark.parametrize("seed", [0, 3, 77, 123456])
@pytest.mark.parametrize("process", PROCESSES)
def test_arrival_streams_equal_reference(process, seed):
    fn = {"poisson": "poisson_arrival_times", "bursty": "bursty_arrival_times",
          "diurnal": "diurnal_arrival_times"}[process]
    assert np.array_equal(getattr(load, fn)(50, 100.0, seed), getattr(ref_load, fn)(50, 100.0, seed))
    got = load.make_arrivals(process, 40, rate=100.0, seed=seed, priorities=(1.0, 2.0, 4.0))
    want = ref_load.make_arrivals(process, 40, rate=100.0, seed=seed, priorities=(1.0, 2.0, 4.0))
    assert [_arr(a) for a in got] == [_arr(a) for a in want]
    assert [a.t for a in got] == sorted(a.t for a in got)


def test_generator_options_and_tenant_mix():
    for kw in (dict(burst=3, duty=0.5), dict(burst=1, duty=1.0)):
        assert np.array_equal(load.bursty_arrival_times(30, 50.0, 4, **kw),
                              ref_load.bursty_arrival_times(30, 50.0, 4, **kw))
    for kw in (dict(period=0.25, depth=0.0), dict(period=3.0, depth=0.5)):
        assert np.array_equal(load.diurnal_arrival_times(30, 50.0, 4, **kw),
                              ref_load.diurnal_arrival_times(30, 50.0, 4, **kw))
    # kinds and priorities come from their own stream: who, never when
    mixes = [[(a.kind, a.priority) for a in load.make_arrivals(p, 30, seed=3, priorities=(1.0, 2.0))]
             for p in PROCESSES]
    assert mixes[0] == mixes[1] == mixes[2]
    assert load.make_arrivals("poisson", 0) == [] == ref_load.make_arrivals("poisson", 0)
    kinds = ("a", "b")
    assert [_arr(a) for a in load.make_arrivals("bursty", 9, seed=2, kinds=kinds)] == [
        _arr(a) for a in ref_load.make_arrivals("bursty", 9, seed=2, kinds=kinds)]
    assert sorted(load.default_catalog()) == sorted(ref_load.default_catalog())


@pytest.mark.parametrize("call", [
    lambda m: m.poisson_arrival_times(10, 0.0), lambda m: m.poisson_arrival_times(-1, 1.0),
    lambda m: m.bursty_arrival_times(10, 100.0, duty=0.0),
    lambda m: m.bursty_arrival_times(10, 100.0, burst=0),
    lambda m: m.diurnal_arrival_times(10, 100.0, depth=1.0),
    lambda m: m.diurnal_arrival_times(10, 100.0, period=0.0), lambda m: m.make_arrivals("weekly", 10),
    lambda m: m.Arrival(-1.0, "x", 0), lambda m: m.Arrival(0.0, "", 0),
    lambda m: m.Arrival(0.0, "x", -1), lambda m: m.Arrival(0.0, "x", 0, 0.0),
])
def test_generator_and_arrival_refusals(call):
    with pytest.raises(ValueError) as want:
        call(ref_load)
    with pytest.raises(ValueError) as got:
        call(load)
    assert str(got.value) == str(want.value)


def test_save_trace_byte_for_byte_and_round_trip(tmp_path):
    arr = ref_load.make_arrivals("diurnal", 12, seed=9, priorities=(1.0, 4.0))
    mine, theirs = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    load.save_trace([_arr(a) for a in arr], str(mine))
    ref_load.save_trace(arr, str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()
    back = load.load_trace(str(mine))
    assert [_arr(a) for a in back] == [_arr(a) for a in ref_load.load_trace(str(theirs))]
    lines = [json.loads(line) for line in mine.read_text().splitlines()]
    assert all(("priority" in o) == (o.get("priority", 1.0) != 1.0) for o in lines)
    text = ('# a comment\n\n{"t": 1.0, "kind": "a", "tenant": 2}\n'
            '{"t": 0.5, "kind": "b", "tenant": 9}\n{"t": 1.0, "kind": "c", "tenant": 1}\n')
    p = tmp_path / "sorted.jsonl"
    p.write_text(text)
    assert [_arr(a) for a in load.load_trace(str(p))] == [
        _arr(a) for a in ref_load.load_trace(str(p))] == [
        (0.5, "b", 9, 1.0), (1.0, "c", 1, 1.0), (1.0, "a", 2, 1.0)]


@pytest.mark.parametrize("line", [
    "not json", "[1, 2]", '{"kind": "x", "tenant": 0}', '{"t": 1.0, "tenant": 0}',
    '{"t": 1.0, "kind": "x"}', '{"t": true, "kind": "x", "tenant": 0}',
    '{"t": -1, "kind": "x", "tenant": 0}', '{"t": 1, "kind": 3, "tenant": 0}',
    '{"t": 1, "kind": "", "tenant": 0}', '{"t": 1, "kind": "x", "tenant": 1.5}',
    '{"t": 1, "kind": "x", "tenant": -2}', '{"t": 1, "kind": "x", "tenant": 0, "priority": 0}',
    '{"t": 1, "kind": "x", "tenant": 0, "priority": "hi"}',
    '{"t": 1, "kind": "x", "tenant": 0, "extra": 1}',
])
def test_load_trace_errors_name_file_and_line(tmp_path, line):
    p = tmp_path / "trace.jsonl"
    p.write_text('{"t": 0.1, "kind": "ok", "tenant": 0}\n' + line + "\n")
    with pytest.raises(ValueError) as want:
        ref_load.load_trace(str(p))
    with pytest.raises(ValueError) as got:
        load.load_trace(str(p))
    assert str(got.value) == str(want.value)
    assert f"{p}:2" in str(got.value)


# ---------------------------------------------------------------------------
# the serving aggregates


def test_percentile_jain_and_report_equal_reference():
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 7, 100):
        xs = rng.exponential(2.0, size=n).tolist()
        for q in (0, 1, 50, 99, 100):
            assert percentile(xs, q) == ref_percentile(xs, q)
        assert jain_fairness(xs) == ref_jain(xs)
        rows = [dict(makespan=x, slowdown=x / 2, queue_delay=x / 3) for x in xs]
        assert serving_report(rows) == ref_serving_report(rows)
    assert jain_fairness([0.0, 0.0]) == 1.0
    with pytest.raises(ValueError, match="percentile"):
        percentile([1.0], 101)


def test_wfq_retire_tenant_equal_reference():
    class Ctx:
        def __init__(self, gid, priority):
            self.gid, self.priority = gid, priority

    port, ref = WFQPolicy(device="cpu"), RefWFQ()
    tenants = [Ctx(g, p) for g, p in enumerate((1.0, 2.0, 0.5, 1.0))]
    for step, (g, dur) in enumerate([(0, 0.3), (1, 0.5), (2, 0.1), (0, 0.2), (3, 0.4), (1, 0.1)]):
        for pol in (port, ref):
            pol.charge_tenant(tenants[g], dur)
            if step == 3:
                pol.retire_tenant(tenants[2])
                pol.retire_tenant(tenants[2])  # twice: a no-op
        assert port._vt == ref._vt
        assert [port.tenant_scale(None, c) for c in tenants] == [
            ref.tenant_scale(None, c) for c in tenants]


# ---------------------------------------------------------------------------
# run_serving: every tenant of every run equal to the reference's


@lru_cache(maxsize=None)
def _serving_pair(n, process, spec, mode):
    arr = load.make_arrivals(process, n, rate=2000.0, seed=7)
    ref_arr = ref_load.make_arrivals(process, n, rate=2000.0, seed=7)
    assert [_arr(a) for a in arr] == [_arr(a) for a in ref_arr]
    out = load.run_serving(arr, paper_machine(4), spec, seed=0, rescore=mode, device="cpu")
    want = ref_load.run_serving(ref_arr, ref_paper_machine(4), spec, seed=0, rescore=mode)
    return _serving_fp(out), _serving_fp(want)


@pytest.mark.parametrize("mode", ["incremental", "full"])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("process", PROCESSES)
@pytest.mark.parametrize("n", [16, 64])
def test_run_serving_equals_reference(n, process, spec, mode):
    got, want = _serving_pair(n, process, spec, mode)
    assert got == want
    assert got[0]["report"]["n_tenants"] == n == got[0]["n_admitted"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("process", PROCESSES)
@pytest.mark.parametrize("n", [16, 64])
def test_full_and_incremental_place_alike(n, process, spec):
    full, inc = _serving_pair(n, process, spec, "full")[0], _serving_pair(n, process, spec, "incremental")[0]
    assert full[2][0] == inc[2][0]  # every tenant's intervals and arrival state
    assert full[0]["report"] == inc[0]["report"]
    assert inc[0]["rows_built"] < full[0]["rows_built"]


def test_max_events_probe_equals_reference():
    arr = load.make_arrivals("poisson", 64, rate=2000.0, seed=7)
    ref_arr = ref_load.make_arrivals("poisson", 64, rate=2000.0, seed=7)
    for mode in ("full", "incremental"):
        out = load.run_serving(arr, paper_machine(4), "heft", seed=0, rescore=mode,
                               max_events=800, device="cpu")
        want = ref_load.run_serving(ref_arr, ref_paper_machine(4), "heft", seed=0, rescore=mode,
                                    max_events=800)
        assert out["results"] == [] and out["tenants"] == []
        assert _serving_fp(out) == _serving_fp(want)
        assert out["n_events"] == 800


def test_zero_tenant_run():
    eng = Engine(paper_machine(2), port_policy("heft"), seed=0, rescore="incremental",
                 device="cpu")
    assert eng.run() == []
    out = load.run_serving([], paper_machine(2), "heft", seed=0, device="cpu")
    want = ref_load.run_serving([], ref_paper_machine(2), "heft", seed=0)
    assert _serving_fp(out)[0] == _serving_fp(want)[0]
    assert out["report"]["n_tenants"] == 0 and out["report"]["jain_fairness"] == 1.0


def test_one_graph_engine_equals_simulator():
    e1 = Engine(paper_machine(4), port_policy("heft"), seed=0, noise=0.05)
    e1.submit(cholesky_graph(6, 256))
    e2 = Engine(paper_machine(4), port_policy("heft"), seed=0, noise=0.05, rescore="off",
                admission="none", admit_defer_s=0.005)
    e2.submit(cholesky_graph(6, 256))
    sim = Simulator(cholesky_graph(6, 256), paper_machine(4), port_policy("heft"), seed=0,
                    noise=0.05).run()
    ref = RefEngine(ref_paper_machine(4), ref_policy("heft"), seed=0, noise=0.05)
    ref.submit(ref_cholesky_graph(6, 256, with_fns=False))
    r1, r2, rr = e1.run()[0], e2.run()[0], ref.run()[0]
    assert _res(r1) == _res(r2) == _res(rr)
    assert (r1.makespan, r1.total_bytes, [(iv.tid, iv.rid, iv.start, iv.end) for iv in r1.intervals]
            ) == (sim.makespan, sim.total_bytes,
                  [(iv.tid, iv.rid, iv.start, iv.end) for iv in sim.intervals])


def test_unknown_kind_refused_at_submit():
    with pytest.raises(ValueError, match="not in catalog"):
        load.run_serving([load.Arrival(0.0, "nope", 0)], paper_machine(2), "heft", device="cpu")


def test_priorities_and_priority_policy_equal_reference():
    arr = load.make_arrivals("bursty", 24, rate=800.0, seed=11, priorities=(1.0, 2.0, 4.0))
    ref_arr = ref_load.make_arrivals("bursty", 24, rate=800.0, seed=11, priorities=(1.0, 2.0, 4.0))
    for spec in ("wfq", "priority", "locality"):
        out = load.run_serving(arr, paper_machine(3), spec, seed=2, noise=0.03, device="cpu")
        want = ref_load.run_serving(ref_arr, ref_paper_machine(3), spec, seed=2, noise=0.03)
        assert _serving_fp(out) == _serving_fp(want), spec


# ---------------------------------------------------------------------------
# the pool: one score_pool call a round, rows equal to the host rows


@pytest.mark.parametrize("min_wide", [1, 4, 10**6])
def test_one_pool_scoring_per_round_from_min_wide(min_wide, monkeypatch):
    calls, wide_rounds = [], []
    real_pool = TorchScoringBackend.score_pool
    real_rebuild = ServingScheduler._rebuild

    def pool(self, groups, resources, transfer_model):
        calls.append(sum(len(t) for _, t in groups))
        return real_pool(self, groups, resources, transfer_model)

    def rebuild(self, engine, keys):
        n = sum(1 for k in keys if k in self.entries)
        if n >= self.min_wide:
            wide_rounds.append(n)
        return real_rebuild(self, engine, keys)

    monkeypatch.setattr(TorchScoringBackend, "score_pool", pool)
    monkeypatch.setattr(ServingScheduler, "_rebuild", rebuild)
    arr = load.make_arrivals("poisson", 32, rate=2000.0, seed=7)
    out = load.run_serving(arr, paper_machine(4), "heft", seed=0, device="cpu", min_wide=min_wide)
    assert calls == wide_rounds  # exactly one pool scoring per wide round
    assert (len(calls) > 0) == (min_wide < 10**6)
    ref_arr = ref_load.make_arrivals("poisson", 32, rate=2000.0, seed=7)
    want = ref_load.run_serving(ref_arr, ref_paper_machine(4), "heft", seed=0)
    assert _serving_fp(out) == _serving_fp(want)


def _wide_graph(builder, data_cls, mode_cls, n_tasks=40, n_data=12, seed=4):
    """A graph of ``n_tasks`` independent readers (all roots: the first
    round builds them all), each reading 1-3 of ``n_data`` data and
    writing one output of its own."""
    rng = np.random.default_rng(seed)
    datas = [data_cls(f"d{i}", int(rng.integers(1_000, 4 * MB))) for i in range(n_data)]
    g = builder()
    for t in range(n_tasks):
        picks = rng.choice(n_data, size=int(rng.integers(1, 4)), replace=False)
        acc = [(datas[i], mode_cls.R) for i in picks] + [(data_cls(f"o{t}", 4096), mode_cls.W)]
        g.add_task("gemm", acc, flops=float(rng.integers(1, 50)) * 1e8)
    return g


def test_pool_rows_of_several_graphs_equal_reference_host_rows():
    """score_pool over groups of three graphs (one of 40 rows: the
    reference's wide numpy path) under seeded residencies with device
    copies, against the reference's task_input_transfer_rows plus the
    static durations."""
    port = Engine(paper_machine(4), port_policy("heft"), seed=0)
    ref = RefEngine(ref_paper_machine(4), ref_policy("heft"), seed=0)
    graphs = [(_wide_graph(RefTaskGraph, RefDataObject, RefMode), "wide"),
              (ref_lu_graph(4, 256, with_fns=False), "lu"),
              (_random_graph(3), "random")]
    rng = np.random.default_rng(9)
    groups, want = [], []
    for g, _ in graphs:
        pc, rc = port.submit(graph_from_spec(graph_spec(g))), ref.submit(g)
        for name in rc.arrays.data_names:
            for mem in (0, 1, 2, 3):
                if rng.random() < 0.3:
                    pc.residency.add_copy(name, mem)
                    rc.residency.add_copy(name, mem)
            draw = rng.random()
            if draw < 0.2:  # the sole copy on a device: two hops elsewhere
                for res in (pc.residency, rc.residency):
                    res.write(name, 2)
            elif draw < 0.25:  # nowhere yet (no transfer)
                for res in (pc.residency, rc.residency):
                    res.drop_copy(name, -1)
        tids = list(range(40)) if len(g) >= 40 else sorted(
            rng.choice(len(g), size=len(g) // 2, replace=False).tolist())
        groups.append((pc, tids))
        X = ref.transfer_model.task_input_transfer_rows(rc.arrays, tids, ref._mem_of, rc.residency)
        want += [[x[j] + rc.rid_static[j][t] for j in range(len(x))] for x, t in zip(X, tids)]
    assert max(len(t) for _, t in groups) >= 32
    C = TorchScoringBackend("cpu").score_pool(groups, port.machine.resources, port.transfer_model)
    assert C.tolist() == want
    for ctx, tids in groups:  # each group alone, too
        one = TorchScoringBackend("cpu").score_pool([(ctx, tids)], port.machine.resources,
                                                    port.transfer_model)
        assert one.shape == (len(tids), len(port.machine.resources))


def test_wide_root_round_equals_reference():
    """A tenant whose 40 roots arrive at once: one round rebuilds 40 rows
    of one graph (the reference's wide path), in both modes."""
    for mode in ("incremental", "full"):
        port = Engine(paper_machine(4), port_policy("heft"), seed=0, rescore=mode, device="cpu")
        ref = RefEngine(ref_paper_machine(4), ref_policy("heft"), seed=0, rescore=mode)
        for k in range(3):
            g = _wide_graph(RefTaskGraph, RefDataObject, RefMode, seed=k)
            ref.submit(g, at=0.001 * k)
            port.submit(graph_from_spec(graph_spec(g)), at=0.001 * k)
        assert [_res(r) for r in port.run()] == [_res(r) for r in ref.run()]
        assert _engine_fp(port) == _engine_fp(ref)


def test_serving_under_capacity_and_faults_equals_reference():
    """Bounded memories (every round rebuilds everything, with the
    pressure rows added after the scorer) and a detach with a notice (the
    epoch bump, +inf dead columns and the notice penalty)."""
    arr = load.make_arrivals("poisson", 24, rate=3000.0, seed=5)
    ref_arr = ref_load.make_arrivals("poisson", 24, rate=3000.0, seed=5)
    out = load.run_serving(arr, paper_machine(4), "dada?alpha=0.5&use_cp=1", seed=0,
                           mem_capacity=8 * MB, device="cpu")
    want = ref_load.run_serving(ref_arr, ref_paper_machine(4), "dada?alpha=0.5&use_cp=1",
                                seed=0, mem_capacity=8 * MB)
    assert _serving_fp(out) == _serving_fp(want)
    assert out["engine"].metrics.n_evictions > 0
    for mode in ("drain", "kill"):
        port = Engine(paper_machine(4), port_policy("heft"), seed=1, rescore="incremental",
                      device="cpu")
        ref = RefEngine(ref_paper_machine(4), ref_policy("heft"), seed=1, rescore="incremental")
        for e, g in ((port, cholesky_graph), (ref, ref_cholesky_graph)):
            for k in range(4):
                e.submit(g(5, 256, with_fns=False), at=0.003 * k)
            gpu = e.machine.gpus[1].rid
            e.inject("detach", gpu, at=0.006, mode=mode, notice_s=0.002)
            e.inject("attach", gpu, at=0.02)
        assert [_res(r) for r in port.run()] == [_res(r) for r in ref.run()]
        assert _engine_fp(port) == _engine_fp(ref)
        assert port.metrics.n_notices == 1


# ---------------------------------------------------------------------------
# admission control


def _admission_pair(seed, mode, n=16, audit=False):
    catalog, ref_catalog = load.default_catalog(), ref_load.default_catalog()
    probe = Engine(paper_machine(2), port_policy("heft"), seed=0)
    ws = max(probe.submit(b()).ws_bytes for b in catalog.values())
    runs = []
    for pkg, eng in (
            (load, Engine(paper_machine(4), port_policy("heft"), seed=0, rescore="incremental",
                          admission=mode, mem_capacity=ws, audit=audit, device="cpu")),
            (ref_load, RefEngine(ref_paper_machine(4), ref_policy("heft"), seed=0,
                                 rescore="incremental", admission=mode, mem_capacity=ws,
                                 audit=audit))):
        peaks, orig = [], eng._arrive

        def watched(ctx, orig=orig, eng=eng, peaks=peaks):
            orig(ctx)
            peaks.append(eng._active_ws)

        eng._arrive = watched
        cat = catalog if pkg is load else ref_catalog
        for a in pkg.make_arrivals("poisson", n, rate=5000.0, seed=seed):
            eng.submit(cat[a.kind](), at=a.t, priority=a.priority)
        runs.append((eng, [_res(r) for r in eng.run()], peaks))
    return runs


@pytest.mark.parametrize("mode", ["reject", "defer"])
@pytest.mark.parametrize("seed", SEEDS)
def test_admission_equals_reference(seed, mode):
    (port, got, peaks), (ref, want, ref_peaks) = _admission_pair(seed, mode)
    assert got == want and peaks == ref_peaks
    assert _engine_fp(port) == _engine_fp(ref)
    m = port.metrics
    assert m.n_arrivals == 16 and max(peaks) <= port._mem_total and port._active_ws == 0
    if mode == "reject":
        assert m.n_admitted + m.n_rejected == 16
    else:
        assert m.n_admitted == 16 - m.n_rejected


def test_oversized_tenant_rejected_outright():
    ws = Engine(paper_machine(1), port_policy("heft"), seed=0).submit(
        load.default_catalog()["chol4"]()).ws_bytes
    runs = []
    for eng, cat in ((Engine(paper_machine(1), port_policy("heft"), seed=0, rescore="incremental",
                             admission="defer", mem_capacity=ws // 2, device="cpu"),
                      load.default_catalog()),
                     (RefEngine(ref_paper_machine(1), ref_policy("heft"), seed=0,
                                rescore="incremental", admission="defer", mem_capacity=ws // 2),
                      ref_load.default_catalog())):
        assert eng._mem_total < ws
        ctx = eng.submit(cat["chol4"](), at=0.0)
        results = eng.run()
        assert ctx.rejected and eng.metrics.n_rejected == 1 and eng.metrics.n_deferred == 0
        runs.append(([_res(r) for r in results], _engine_fp(eng)))
    assert runs[0] == runs[1]
    assert runs[0][0][0][0] == 0.0 and runs[0][0][0][-1] is False  # makespan 0, not admitted


# ---------------------------------------------------------------------------
# refusals


def test_engine_refusals_equal_reference():
    def both(**kw):
        with pytest.raises(ValueError) as want:
            RefEngine(ref_paper_machine(2), ref_policy(kw.pop("spec", "heft")), seed=0, **kw)
        return str(want.value)

    cases = [dict(rescore="sometimes"), dict(admission="maybe"),
             dict(spec="ws", rescore="incremental"), dict(admission="reject"),
             dict(rescore="full", admit_defer_s=0.0)]
    for kw in cases:
        msg = both(**dict(kw))
        spec = kw.pop("spec", "heft")
        with pytest.raises(ValueError) as got:
            Engine(paper_machine(2), port_policy(spec), seed=0, device="cpu", **kw)
        assert str(got.value) == msg
    with pytest.raises(ValueError, match="max_events"):
        Engine(paper_machine(2), port_policy("heft"), seed=0).run(max_events=10)
    with pytest.raises(ValueError, match="min_wide"):
        Engine(paper_machine(2), port_policy("heft"), rescore="full", device="cpu", min_wide=0)


def test_serving_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(paper_machine(2), port_policy("heft"), seed=0, rescore="incremental")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load.run_serving(load.make_arrivals("poisson", 2, seed=0), paper_machine(2), "heft")
    # the classic loop takes no device
    Engine(paper_machine(2), port_policy("heft"), seed=0)


# ---------------------------------------------------------------------------
# streamed tenants in the classic loop (tests/test_runtime.py's cases)


def _submit_four(engine, builders):
    ctxs = []
    for i, gf in enumerate(builders):
        at = None if i < 2 else 0.02 * i  # two at t=0, two streamed in later
        ctxs.append(engine.submit(gf(6, 256, with_fns=False), at=at))
    return ctxs


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "ws", "dada?alpha=0.5"])
def test_four_graph_stream_equals_reference(spec):
    port = Engine(paper_machine(4), port_policy(spec), seed=0)
    ref = RefEngine(ref_paper_machine(4), ref_policy(spec), seed=0)
    ctxs = _submit_four(port, (cholesky_graph, lu_graph, qr_graph, cholesky_graph))
    _submit_four(ref, (ref_cholesky_graph, ref_lu_graph, ref_qr_graph, ref_cholesky_graph))
    got, want = port.run(), ref.run()
    assert [_res(r) for r in got] == [_res(r) for r in want]
    assert _engine_fp(port) == _engine_fp(ref)
    assert all(iv.start >= ctx.submit_at for ctx in ctxs[2:] for iv in ctx.intervals)
    assert [c.submit_at for c in ctxs] == [0.0, 0.0, 0.04, 0.06]


def test_submit_after_run_start_and_during_the_run_equal_reference():
    def late(engine, build, lu):
        first = engine.submit(build(6, 256, with_fns=False))
        engine.submit(lu(5, 256, with_fns=False), at=0.01)
        return first

    port = Engine(paper_machine(2), port_policy("heft"), seed=0)
    ref = RefEngine(ref_paper_machine(2), ref_policy("heft"), seed=0)
    late(port, cholesky_graph, lu_graph)
    late(ref, ref_cholesky_graph, ref_lu_graph)
    assert [_res(r) for r in port.run()] == [_res(r) for r in ref.run()]
    assert port._ctxs[1].submit_at == 0.01

    class SubmitOnce:
        """Wraps a policy; its first placement (or, serving, its first
        tenant scale) submits one more graph: a submit during the run."""

        def __init__(self, inner, build):
            self.inner, self.build, self.fired = inner, build, False
            self.name, self.allow_steal, self.owner_lifo = inner.name, False, False

        def init(self, sim):
            self.inner.init(sim)

        def _fire(self, sim):
            if not self.fired and sim.now > 0:
                self.fired = True
                sim.submit(self.build(3, 256, with_fns=False), priority=2.0)

        def place(self, sim, ready, src):
            self._fire(sim)
            self.inner.place(sim, ready, src)

        def tenant_scale(self, sim, ctx):
            self._fire(sim)
            return 1.0

    for rescore in ("off", "incremental"):
        kw = {} if rescore == "off" else dict(rescore=rescore)
        port = Engine(paper_machine(3), SubmitOnce(port_policy("heft"), qr_graph), seed=4,
                      device="cpu", **kw)
        ref = RefEngine(ref_paper_machine(3), SubmitOnce(ref_policy("heft"), ref_qr_graph),
                        seed=4, **kw)
        port.submit(cholesky_graph(5, 256))
        ref.submit(ref_cholesky_graph(5, 256, with_fns=False))
        assert [_res(r) for r in port.run()] == [_res(r) for r in ref.run()]
        assert _engine_fp(port) == _engine_fp(ref)
        assert len(port._ctxs) == 2 and port._ctxs[1].submit_at > 0


def test_double_submission_refused():
    eng = Engine(paper_machine(2), port_policy("heft"), seed=0)
    g = cholesky_graph(4, 256)
    eng.submit(g)
    with pytest.raises(ValueError, match="already submitted"):
        eng.submit(g)
    eng.submit(cholesky_graph(4, 256))
    assert len(eng.run()) == 2
    with pytest.raises(ValueError, match="priority"):
        eng.submit(cholesky_graph(2, 256), priority=0.0)


def test_mid_run_submit_during_fault_drain_equals_reference():
    detach_t, attach_t = 0.005, 0.08
    runs = []
    for eng, chol, lu in ((Engine(paper_machine(2), port_policy("heft"), seed=0,
                                  rescore="incremental", device="cpu"), cholesky_graph, lu_graph),
                          (RefEngine(ref_paper_machine(2), ref_policy("heft"), seed=0,
                                     rescore="incremental"), ref_cholesky_graph, ref_lu_graph)):
        first = eng.submit(chol(8, 256, with_fns=False))
        gpu = eng.machine.gpus[0].rid
        eng.inject("detach", gpu, at=detach_t, mode="drain")
        eng.inject("attach", gpu, at=attach_t)
        late = eng.submit(lu(5, 256, with_fns=False), at=0.01)
        results = eng.run()
        assert first.n_done == first.n_tasks and late.n_done == late.n_tasks
        assert eng.metrics.n_arrivals == 2 and min(iv.start for iv in late.intervals) >= 0.01
        for iv in eng.metrics.intervals:
            if iv.rid == gpu:
                assert not (detach_t + 1e-12 < iv.start < attach_t - 1e-12)
        runs.append(([_res(r) for r in results], _engine_fp(eng)))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# stale-transfer cancellation


class PinGpu0:
    name = "pin0"
    allow_steal = False
    owner_lifo = False

    def init(self, sim):
        self.gpu = sim.machine.gpus[0].rid

    def place(self, sim, ready, src):
        for t in ready:
            sim.push(t, self.gpu)


def _stale_pair(cancel, audit=False):
    """A copy of ``d`` in flight to memory 1 while a task on GPU 0
    overwrites ``d`` (tests/test_runtime.py's case), in both packages."""
    sims = []
    for sim_cls, data, mode, graph, machine in (
            (Simulator, DataObject, Mode, TaskGraph, paper_machine),
            (RefSimulator, RefDataObject, RefMode, RefTaskGraph, ref_paper_machine)):
        g = graph()
        g.add_task("w", [(data("e", 1000), mode.R), (data("d", 50 * MB), mode.W)], flops=1e6)
        sim = sim_cls(g, machine(2), PinGpu0(), seed=0, noise=0.0, cancel_stale=cancel,
                      audit=audit)
        sim.request_transfer("d", 50 * MB, 1)
        sims.append((sim, sim.run()))
    return sims


@pytest.mark.parametrize("cancel", [False, True])
def test_stale_landing_equals_reference(cancel, tmp_path):
    (port, got), (ref, want) = _stale_pair(cancel, audit=True)
    assert _res(got) == _res(want)
    assert port.residency._mask == ref.residency._mask
    # the stale copy at memory 1 (bit 2) lands unless cancelled; with
    # cancel_stale the rewritten copy on GPU 0's memory is the only one
    assert bool(port.residency._mask["d"] & (1 << 2)) == (not cancel)
    if cancel:
        assert port.residency._mask["d"] == 1 << 1
    assert _jsonl(port.audit, tmp_path / "p") == _jsonl(ref.audit, tmp_path / "r")
    stale = [r for r in port.audit.landings if r.reason == "stale"]
    assert len(stale) == int(cancel)
    assert errors(verify_audit(port.audit)) == []


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "ws"])
def test_cancel_stale_runs_equal_reference(spec, tmp_path):
    """Whole runs with cancel_stale on, audited: results, logs (with
    cancel_stale in the machine record) and the verifier's 0 errors; a
    run with no overwritten copy in flight equals the run without it."""
    runs = {}
    for cancel in (False, True):
        port = Simulator(lu_graph(6, 256), paper_machine(3), port_policy(spec), seed=5,
                         noise=0.05, cancel_stale=cancel, audit=True)
        ref = RefSimulator(ref_lu_graph(6, 256, with_fns=False), ref_paper_machine(3),
                           ref_policy(spec), seed=5, noise=0.05, cancel_stale=cancel, audit=True)
        got, want = port.run(), ref.run()
        assert _res(got) == _res(want)
        assert _jsonl(port.audit, tmp_path / f"p{cancel}") == _jsonl(ref.audit, tmp_path / f"r{cancel}")
        assert errors(verify_audit(port.audit)) == []
        assert port.audit.machine["cancel_stale"] is cancel
        runs[cancel] = (got, port)
    if not any(r.reason == "stale" for r in runs[True][1].audit.landings):
        assert _res(runs[False][0]) == _res(runs[True][0])


# ---------------------------------------------------------------------------
# audited serving


def _jsonl(log, path):
    log.to_jsonl(str(path))
    return Path(path).read_text().splitlines()


@pytest.mark.parametrize("spec", SPECS)
def test_audited_serving_log_equals_reference(spec, tmp_path):
    arr = load.make_arrivals("bursty", 20, rate=2000.0, seed=3)
    ref_arr = ref_load.make_arrivals("bursty", 20, rate=2000.0, seed=3)
    out = load.run_serving(arr, paper_machine(4), spec, seed=0, audit=True, device="cpu")
    want = ref_load.run_serving(ref_arr, ref_paper_machine(4), spec, seed=0, audit=True)
    assert _serving_fp(out) == _serving_fp(want)
    log = out["engine"].audit
    assert _jsonl(log, tmp_path / "p") == _jsonl(want["engine"].audit, tmp_path / "r")
    assert errors(verify_audit(log)) == []
    assert len(log.arrivals) == len(log.admits) == 20


@pytest.mark.parametrize("mode", ["reject", "defer"])
def test_audited_admission_log_equals_reference(mode, tmp_path):
    (port, got, _), (ref, want, _) = _admission_pair(1, mode, audit=True)
    assert got == want
    assert _jsonl(port.audit, tmp_path / "p") == _jsonl(ref.audit, tmp_path / "r")
    assert errors(verify_audit(port.audit)) == []
    assert len(port.audit.rejects) == port.metrics.n_rejected


def test_audited_cancel_stale_serving_log_equals_reference(tmp_path):
    port = Engine(paper_machine(3), port_policy("heft"), seed=2, noise=0.05, rescore="incremental",
                  cancel_stale=True, audit=True, device="cpu")
    ref = RefEngine(ref_paper_machine(3), ref_policy("heft"), seed=2, noise=0.05,
                    rescore="incremental", cancel_stale=True, audit=True)
    for e, builders in ((port, (cholesky_graph, lu_graph, qr_graph, cholesky_graph)),
                        (ref, (ref_cholesky_graph, ref_lu_graph, ref_qr_graph, ref_cholesky_graph))):
        _submit_four(e, builders)
    assert [_res(r) for r in port.run()] == [_res(r) for r in ref.run()]
    assert _jsonl(port.audit, tmp_path / "p") == _jsonl(ref.audit, tmp_path / "r")
    assert errors(verify_audit(port.audit)) == []


# ---------------------------------------------------------------------------
# the benchmarks


def test_scenario_matrix_fast_rows_equal_reference(monkeypatch, capsys):
    rows, checks = sm.run_matrix(*sm.FAST, device="cpu", verbose=False)
    monkeypatch.setenv("REPRO_BENCH_FAST", "1")
    want_rows, want_checks = ref_sm.run_matrix()
    assert rows == want_rows
    assert checks == want_checks
    assert checks and all(c["passed"] for c in checks)
    assert sm.print_checks(checks)
    assert "[PASS] C9 notice cuts waste" in capsys.readouterr().out


def test_serving_rows_equal_reference(capsys):
    rows = sl.serving_rows([16], 2000.0, device="cpu", reps=1)
    want = ref_sl.serving_rows([16], 2000.0)
    assert len(rows) == len(want) == 9
    for row, ref_row in zip(rows, want):
        assert {k: row[k] for k in ref_row if k not in sl.WALL_FIELDS} == {
            k: v for k, v in ref_row.items() if k not in sl.WALL_FIELDS}
        assert row["rounds"] > 0


def test_bench_clis(capsys):
    assert sl.main(["--tenants", "4", "--device", "cpu", "--probe-events", "200"]) == 0
    out = capsys.readouterr().out.splitlines()
    payload = json.loads(out[-1])["serving_load"]
    assert len(payload["rows"]) == 9 and payload["speedup"]["full"]["events"] == 200
    assert payload["speedup"]["incremental"]["rows_built"] < payload["speedup"]["full"]["rows_built"]
    assert sm.main(["--fast", "--runs", "1", "--device", "cpu"]) in (0, 1)
    assert "scenario-matrix claims" in capsys.readouterr().out
