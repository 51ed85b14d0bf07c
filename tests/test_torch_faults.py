"""The port's fault layer against ``repro.runtime.faults``: detach and
attach, drain and kill, notices, churn, trace replay, flaky links and the
recovery report, on the same inputs in both packages.

Each case runs the reference (its numpy scoring path, which is also its
scalar path under faults) and the port (``device="cpu"``: the plain
versions of the kernels) on the same graph, machine, strategy, seed and
fault script, and holds the port to the reference: makespan, bytes,
transfers, busy times, every interval and ``SimResult.faults`` are
equal, floats exact. On top, the invariants of ``tests/test_faults.py``
and ``tests/test_faults_property.py`` hold on the port's runs: every task
completes exactly once, nothing starts on a worker inside its dead window
(nor inside a notice window), no datum is lost, no worker is
double-booked, retries stay within their budget. The property tests'
random schedules are drawn here from fixed seeds. Left out: the
reference's environment knobs (the port has none) and its elastic
re-planner (``repro/dist``).
"""
import math

import numpy as np
import pytest

from repro.configs.paper_machine import paper_machine as ref_paper_machine
from repro.core.simulator import Simulator as RefSimulator
from repro.linalg.cholesky import cholesky_graph as ref_cholesky_graph
from repro.linalg.lu import lu_graph as ref_lu_graph
from repro.runtime import FaultEvent as RefFaultEvent
from repro.runtime import load_trace as ref_load_trace
from repro.runtime import recovery_report as ref_recovery_report
from repro.runtime import save_trace as ref_save_trace
from repro.sched import resolve as ref_resolve
from repro_torch.bench import paper_validation as pv
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.core import Simulator
from repro_torch.linalg.cholesky import cholesky_graph
from repro_torch.linalg.lu import lu_graph
from repro_torch.runtime.faults import FaultManager
from repro_torch.runtime.metrics import recovery_report
from repro_torch.runtime.traces import FAULT_MODES, FaultEvent, load_trace, save_trace
from repro_torch.sched import resolve
from repro_torch.verify import errors, verify_audit

MB = 1024 * 1024
KERNELS = {"cholesky": (ref_cholesky_graph, cholesky_graph), "lu": (ref_lu_graph, lu_graph)}
# every strategy of the port that runs through faults: the placing ones on
# the CPU backend, the queue protocol and the score-matrix policies
SPECS = ("heft", "dada?alpha=0.5&use_cp=1", "dada?alpha=0.5&use_cp=1&recover=1", "dada?alpha=0",
         "dada?alpha=1&recover=1", "dual", "ws", "locality", "priority", "wfq", "random")


def ref_policy(spec):
    name = spec.split("?")[0]
    return ref_resolve(spec, backend="numpy") if name in ("heft", "dada", "dual") else (
        ref_resolve(spec))


def port_policy(spec):
    return resolve(spec) if spec.split("?")[0] in ("ws", "random") else resolve(spec, device="cpu")


def _fp(res):
    return (
        res.makespan, res.total_bytes, res.n_transfers, tuple(sorted(res.busy.items())),
        tuple((iv.tid, iv.rid, iv.start, iv.end) for iv in res.intervals), res.n_steals,
        res.faults,
    )


def _baseline(spec="heft", nt=6, n=4, seed=0, kernel="cholesky"):
    return Simulator(KERNELS[kernel][1](nt, 256), paper_machine(n), port_policy(spec), seed=seed,
                     noise=0.0).run()


def _pair(spec, script=(), nt=6, n=4, seed=0, noise=0.0, kernel="cholesky", **kw):
    """The reference's and the port's simulators of one run after it.
    ``script``: ``(event, rid, at, mode, notice_s)`` injections, the same
    in both."""
    ref_build, build = KERNELS[kernel]
    ref = RefSimulator(ref_build(nt, 256, with_fns=False), ref_paper_machine(n), ref_policy(spec),
                       seed=seed, noise=noise, **kw)
    port = Simulator(build(nt, 256), paper_machine(n), port_policy(spec), seed=seed, noise=noise,
                     **kw)
    for event, rid, at, mode, notice_s in script:
        ref.inject(event, rid, at=at, mode=mode, notice_s=notice_s)
        port.inject(event, rid, at=at, mode=mode, notice_s=notice_s)
    ref_res, res = ref.run(), port.run()
    assert _fp(res) == _fp(ref_res)
    assert [tuple(vars(e).values()) for e in port.faults.history] == [
        tuple(vars(e).values()) for e in ref.faults.history]
    return port, res


def _dead_windows(history):
    """rid -> [detach, attach) intervals of a fault history."""
    out, open_at = {}, {}
    for e in history:
        if e.event == "detach":
            open_at[e.rid] = e.t
        elif e.event == "attach" and e.rid in open_at:
            out.setdefault(e.rid, []).append((open_at.pop(e.rid), e.t))
    for rid, t in open_at.items():
        out.setdefault(rid, []).append((t, math.inf))
    return out


def _check_invariants(sim, res, graph_len):
    # every task completes exactly once
    assert sorted(iv.tid for iv in res.intervals) == list(range(graph_len))
    # nothing starts on a worker inside its dead window
    windows = _dead_windows(sim.faults.history)
    for iv in res.intervals:
        for lo, hi in windows.get(iv.rid, ()):
            assert not (lo <= iv.start < hi), (iv, lo, hi)
    # no datum lost: a valid copy each, never only on a detached memory
    for name in sim.arrays.data_names:
        locs = sim.residency.locations(name)
        assert locs and locs - sim.faults.dead_mems, name
    # no worker double-booked
    per_worker = {}
    for iv in res.intervals:
        per_worker.setdefault(iv.rid, []).append((iv.start, iv.end))
    for ivs in per_worker.values():
        ivs.sort()
        for (_, e1), (s2, _) in zip(ivs, ivs[1:]):
            assert e1 <= s2 + 1e-9


def _gpus(n=4):
    return [r.rid for r in paper_machine(n).gpus]


# ---------------------------------------------------------------------------
# the injection API


def test_inject_validates_event_mode_rid_and_notice():
    for sim in (Simulator(cholesky_graph(6, 256), paper_machine(2), resolve("heft", device="cpu")),
                RefSimulator(ref_cholesky_graph(6, 256, with_fns=False), ref_paper_machine(2),
                             ref_policy("heft"))):
        with pytest.raises(ValueError, match="event"):
            sim.inject("explode", 0, at=0.0)
        with pytest.raises(ValueError, match="mode"):
            sim.inject("detach", 0, at=0.0, mode="panic")
        with pytest.raises(TypeError):
            sim.inject("detach", "gpu0", at=0.0)
        with pytest.raises(ValueError):
            sim.inject("detach", 99, at=0.0)
        with pytest.raises(ValueError, match="notice_s"):
            sim.inject("attach", 0, at=0.0, notice_s=0.1)
        with pytest.raises(ValueError, match="notice_s"):
            sim.inject("detach", 0, at=0.0, notice_s=-1.0)


@pytest.mark.parametrize("kw,match", [
    (dict(fault_mode="panic"), "fault mode"), (dict(churn=-1.0), "churn rate"),
    (dict(link_flake=1.5), "flake rate"), (dict(link_flake=0.1, retry_max=-1), "retry_max"),
    (dict(link_flake=0.1, backoff_s=-1.0), "backoff_s"),
    (dict(churn=1.0, notice_s=-1.0), "notice_s"),
])
def test_constructor_validates_fault_arguments(kw, match):
    with pytest.raises(ValueError, match=match):
        Simulator(cholesky_graph(4, 256), paper_machine(2), resolve("heft", device="cpu"), **kw)
    with pytest.raises(ValueError, match=match):
        RefSimulator(ref_cholesky_graph(4, 256, with_fns=False), ref_paper_machine(2),
                     ref_policy("heft"), **kw)


def test_detaching_last_worker_rejected():
    """Detaching every worker but one, then the last: the last detach is
    refused when it fires, in both packages."""
    for sim in (Simulator(cholesky_graph(4, 256), paper_machine(1), resolve("heft", device="cpu")),
                RefSimulator(ref_cholesky_graph(4, 256, with_fns=False), ref_paper_machine(1),
                             ref_policy("heft"))):
        rids = [r.rid for r in sim.machine.resources]
        for rid in rids:
            sim.inject("detach", rid, at=0.0, mode="drain")
        with pytest.raises(RuntimeError, match="last alive"):
            sim.run()


def test_dada_raises_when_every_resource_is_detached():
    from repro_torch.core import DADA

    sim = Simulator(cholesky_graph(4, 256), paper_machine(1), DADA(device="cpu"))
    sim.faults.alive = [False] * len(sim.faults.alive)
    sim.faults.dead_rids = frozenset(range(len(sim.faults.alive)))
    sim.faults.any_dead = True
    with pytest.raises(RuntimeError, match="every resource is detached"):
        sim.strategy.place(sim, sim.graph.roots(), None)


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "ws"])
def test_fault_free_runs_carry_no_summary_and_equal_the_plain_run(spec):
    """No fault source: no summary. Churn 0, flake 0, notice 0 and any
    retry budget leave the run bit for bit the plain one; a no-op attach
    turns the machinery on (a summary) and changes nothing else."""
    plain = _baseline(spec)
    assert plain.faults is None
    for kw in (dict(churn=0.0), dict(link_flake=0.0, notice_s=0.0, retry_max=5)):
        res = Simulator(cholesky_graph(6, 256), paper_machine(4), port_policy(spec), seed=0,
                        noise=0.0, **kw).run()
        assert _fp(res) == _fp(plain)
    sim = Simulator(cholesky_graph(6, 256), paper_machine(4), port_policy(spec), seed=0, noise=0.0)
    sim.inject("attach", 0, at=plain.makespan * 0.5)
    res = sim.run()
    assert _fp(res)[:-1] == _fp(plain)[:-1]
    assert res.faults is not None and res.faults["n_attaches"] == 0


# ---------------------------------------------------------------------------
# drain and kill


@pytest.mark.parametrize("mode", FAULT_MODES)
@pytest.mark.parametrize("spec", SPECS)
def test_detach_reattach_matches_reference(spec, mode):
    """Two GPUs lost (a quarter and two fifths into the run), one back at
    three fifths: every strategy's run equals the reference's, completes
    every task once, starts nothing on a dead worker and counts the
    faults."""
    base = _baseline("heft")
    g = _gpus()
    sim, res = _pair(spec, [("detach", g[0], base.makespan * 0.25, mode, None),
                            ("detach", g[1], base.makespan * 0.4, mode, None),
                            ("attach", g[0], base.makespan * 0.6, None, None)], seed=2)
    _check_invariants(sim, res, len(sim.graph))
    assert res.faults["n_detaches"] == 2 and res.faults["n_attaches"] == 1


def _probe():
    base = _baseline("heft")
    gpus = set(_gpus())
    probe = next(iv for iv in base.intervals if iv.rid in gpus and iv.end - iv.start > 1e-6)
    return probe, (probe.start + probe.end) / 2


def test_drain_lets_running_task_finish_on_dead_worker():
    """Drain: the task running at the detach completes where it is, and
    its outputs go to host (the memory is gone)."""
    probe, cut = _probe()
    sim, res = _pair("heft", [("detach", probe.rid, cut, "drain", None)])
    survivor = next(iv for iv in res.intervals if iv.tid == probe.tid)
    assert survivor.rid == probe.rid and survivor.start < cut <= survivor.end
    assert res.faults["n_killed"] == 0 and res.faults["wasted_s"] == 0.0
    _check_invariants(sim, res, len(sim.graph))


def test_kill_aborts_and_requeues_running_task():
    """Kill: the running task is aborted (wasted seconds counted) and
    completes later on a survivor."""
    probe, cut = _probe()
    sim, res = _pair("heft", [("detach", probe.rid, cut, "kill", None)])
    survivor = next(iv for iv in res.intervals if iv.tid == probe.tid)
    assert survivor.rid != probe.rid and survivor.start >= cut
    assert res.faults["n_killed"] >= 1 and res.faults["wasted_s"] > 0.0
    assert res.faults["n_requeued"] >= 1
    _check_invariants(sim, res, len(sim.graph))


@pytest.mark.parametrize("mode", FAULT_MODES)
@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1"])
def test_dirty_data_evacuated_to_host(spec, mode):
    """Sole copies on the detached memory are written back to host, and
    the traffic is in the byte count."""
    base = _baseline(spec)
    sim, res = _pair(spec, [("detach", _gpus()[0], base.makespan * 0.3, mode, None)])
    assert res.faults["n_evacuations"] > 0 and res.faults["evacuated_bytes"] > 0
    if spec == "heft":  # the evacuation traffic shows in the byte count
        assert res.total_bytes >= base.total_bytes
    _check_invariants(sim, res, len(sim.graph))


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "ws"])
def test_attach_rejoins_and_takes_work(spec):
    """A worker detached early and attached at mid-run takes tasks
    again, affinity-cold."""
    base = _baseline("heft", nt=8)
    gpu = _gpus()[0]
    sim, res = _pair(spec, [("detach", gpu, base.makespan * 0.1, "kill", None),
                            ("attach", gpu, base.makespan * 0.5, None, None)], nt=8)
    assert [iv for iv in res.intervals if iv.rid == gpu and iv.start >= base.makespan * 0.5]
    _check_invariants(sim, res, len(sim.graph))


@pytest.mark.parametrize("eviction", ["lru", "affinity"])
@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "locality"])
def test_faults_under_a_memory_capacity(spec, eviction):
    """Bounded memories through a detach: the dead memory's reservations
    are dropped and the run still equals the reference's, counters and
    peaks included."""
    base = _baseline("heft", nt=8)
    g = _gpus()
    sim, res = _pair(spec, [("detach", g[0], base.makespan * 0.2, "kill", None),
                            ("detach", g[1], base.makespan * 0.35, "drain", None),
                            ("attach", g[0], base.makespan * 0.6, None, None)], nt=8,
                     mem_capacity=4 * MB, eviction=eviction)
    assert sim.metrics.n_evictions > 0
    _check_invariants(sim, res, len(sim.graph))


# ---------------------------------------------------------------------------
# preemption notices


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1&recover=1", "ws"])
def test_notice_grace_blocks_new_starts(spec):
    base = _baseline("heft")
    rid, death, window = _gpus()[0], base.makespan * 0.5, base.makespan * 0.2
    sim, res = _pair(spec, [("detach", rid, death, "drain", window)])
    assert sim.metrics.n_notices == 1
    for iv in res.intervals:
        if iv.rid == rid:
            assert not (death - window < iv.start < death), iv
    _check_invariants(sim, res, len(sim.graph))


def test_notice_triggers_proactive_replication():
    """A warning on a worker holding sole copies replicates them to host
    inside the window, counted apart from the salvage at death; the log
    verifies clean."""
    base = _baseline("heft")
    sim, res = _pair("heft", [("detach", _gpus()[0], base.makespan * 0.5, "kill",
                               base.makespan * 0.1)], audit=True)
    assert sim.metrics.n_proactive > 0 and sim.metrics.proactive_bytes > 0
    assert res.faults["n_notices"] == 1
    assert res.faults["proactive_bytes"] == sim.metrics.proactive_bytes
    assert errors(verify_audit(sim.audit)) == []


def test_attach_before_death_cancels_notice():
    base = _baseline("heft")
    rid = _gpus()[0]
    sim, res = _pair("heft", [("detach", rid, base.makespan * 0.4, "drain", base.makespan * 0.2),
                              ("attach", rid, base.makespan * 0.6, None, None)])
    assert rid not in sim.faults.noticed
    _check_invariants(sim, res, len(sim.graph))


def test_subscribers_see_every_transition():
    """An observer subscribed to the fault manager sees each notice,
    detach and attach as it happens, with the engine, in both packages."""
    base = _baseline("heft")
    g0, g1 = _gpus()[:2]
    script = [("detach", g0, base.makespan * 0.3, "drain", base.makespan * 0.1),
              ("detach", g1, base.makespan * 0.4, "kill", None),
              ("attach", g0, base.makespan * 0.6, None, None)]
    ref = RefSimulator(ref_cholesky_graph(6, 256, with_fns=False), ref_paper_machine(4),
                       ref_policy("heft"), seed=0, noise=0.0)
    port = Simulator(cholesky_graph(6, 256), paper_machine(4), port_policy("heft"), seed=0,
                     noise=0.0)
    seen = {}
    for sim in (ref, port):
        log = seen.setdefault(id(sim), [])
        sim.faults.subscribe(lambda engine, event, rid, mode, sim=sim, log=log: log.append(
            (engine is sim, event, rid, mode, sim.now)))
        for event, rid, at, mode, notice_s in script:
            sim.inject(event, rid, at=at, mode=mode, notice_s=notice_s)
        sim.run()
    assert seen[id(port)] == seen[id(ref)]
    assert [e[:4] for e in seen[id(port)]] == [
        (True, "notice", g0, "drain"), (True, "detach", g0, "drain"), (True, "detach", g1, "kill"),
        (True, "attach", g0, None)]


@pytest.mark.parametrize("spec", ["dada?alpha=0.5&use_cp=1&recover=1", "dada?alpha=1&recover=1"])
def test_recover_steers_off_a_noticed_device_and_is_inert_without_notices(spec):
    """Under a notice, recover places differently from plain DADA (and
    still equals the reference); with no notice it changes nothing but
    the name."""
    base = _baseline("heft", nt=8)
    plain_spec = spec.replace("&recover=1", "")
    script = [("detach", _gpus()[0], base.makespan * 0.6, "drain", base.makespan * 0.4)]
    _, rec = _pair(spec, script, nt=8)
    _, plain = _pair(plain_spec, script, nt=8)
    assert _fp(rec)[4] != _fp(plain)[4]
    quiet, quiet_plain = _baseline(spec, nt=8), _baseline(plain_spec, nt=8)
    assert _fp(quiet) == _fp(quiet_plain)
    assert port_policy(spec).name.endswith("+rec")


# ---------------------------------------------------------------------------
# churn


@pytest.mark.parametrize("seed", [0, 7, 13])
@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1",
                                  "dada?alpha=0.5&use_cp=1&recover=1", "ws", "wfq"])
@pytest.mark.parametrize("mode", FAULT_MODES)
def test_churn_matches_reference(spec, mode, seed):
    """Seeded churn (with a notice on odd seeds): the same detaches and
    attaches at the same times as the reference, the same run."""
    sim, res = _pair(spec, nt=8, seed=seed, noise=0.01, churn=300.0, fault_mode=mode,
                     notice_s=0.002 if seed % 2 else 0.0)
    assert res.faults["n_detaches"] == sum(e.event == "detach" for e in sim.faults.history)
    assert sim.faults.history
    _check_invariants(sim, res, len(sim.graph))


def test_churn_same_seed_is_deterministic_and_rate_zero_draws_nothing():
    def run(**kw):
        sim = Simulator(cholesky_graph(6, 256), paper_machine(4), resolve("heft", device="cpu"),
                        seed=7, noise=0.02, **kw)
        res = sim.run()
        return _fp(res), [(e.t, e.event, e.rid) for e in sim.faults.history], sim

    a, b = run(churn=200.0, fault_mode="kill"), run(churn=200.0, fault_mode="kill")
    assert a[:2] == b[:2] and a[1]
    plain, zero = run(), run(churn=0.0)
    assert zero[:2] == plain[:2]
    assert zero[2].faults._rng is None and not zero[2].faults.active
    assert zero[2].rng.bit_generator.state == plain[2].rng.bit_generator.state


def test_churn_stream_is_the_reference_stream():
    """The churn generator's key: (seed & 0xFFFFFFFF, 0xFA017)."""
    fm = FaultManager(paper_machine(4))
    fm.enable_churn(100.0, seed=2**33 + 5)
    want = np.random.default_rng((5, 0xFA017)).random(4)
    assert np.array_equal(fm._rng.random(4), want)


# ---------------------------------------------------------------------------
# traces


def test_trace_save_load_roundtrip(tmp_path):
    evs = [FaultEvent(0.5, "detach", 3, "kill"), FaultEvent(0.1, "detach", 1, "drain"),
           FaultEvent(0.9, "attach", 3)]
    path = tmp_path / "t.jsonl"
    save_trace(evs, str(path))
    back = load_trace(str(path))
    assert [e.t for e in back] == sorted(e.t for e in evs)
    assert back[0] == FaultEvent(0.1, "detach", 1, "drain") and back[2].mode is None
    # the reference writes the same bytes and reads the same events
    ref_path = tmp_path / "ref.jsonl"
    ref_save_trace([RefFaultEvent(e.t, e.event, e.rid, e.mode) for e in evs], str(ref_path))
    assert path.read_bytes() == ref_path.read_bytes()
    assert [tuple(vars(e).values()) for e in ref_load_trace(str(path))] == [
        tuple(vars(e).values()) for e in back]


def test_trace_v1_lines_round_trip_byte_for_byte(tmp_path):
    text = ('{"t": 0.25, "event": "detach", "rid": 2}\n'
            '{"t": 0.5, "event": "detach", "rid": 4, "mode": "kill", "notice_s": 0.125}\n'
            '{"t": 0.75, "event": "attach", "rid": 2}\n')
    path, out = tmp_path / "v1.jsonl", tmp_path / "out.jsonl"
    path.write_text(text)
    evs = load_trace(str(path))
    assert evs[1].notice_s == 0.125 and evs[0].notice_s is None and evs[0].mode is None
    save_trace(evs, str(out))
    assert out.read_text() == text
    save_trace([(e.t, e.event, e.rid, e.mode, e.notice_s) for e in evs], str(out))
    assert out.read_text() == text


@pytest.mark.parametrize("line,needle", [
    ('{"t": 1.0, "event": "detach"}', "rid"),
    ('{"t": 1.0, "event": "melt", "rid": 0}', "event"),
    ('{"t": "soon", "event": "attach", "rid": 0}', "'t'"),
    ('{"t": 1.0, "event": "attach", "rid": 0, "x": 1}', "x"),
    ('{"t": 1.0, "event": "attach", "rid": true}', "rid"),
    ('{"t": -1.0, "event": "attach", "rid": 0}', "time"),
    ('{"t": 1.0, "event": "attach", "rid": -2}', "rid"),
    ('{"t": 1.0, "event": "detach", "rid": 0, "mode": "panic"}', "mode"),
    ('{"t": 1.0, "event": "attach", "rid": 0, "notice_s": 0.1}', "notice_s"),
    ('{"t": 1.0, "event": "detach", "rid": 0, "notice_s": -0.1}', "notice_s"),
    ('{"t": 1.0, "event": "detach", "rid": 0, "notice_s": "x"}', "notice_s"),
    ("[1, 2]", "JSON object"),
    ("not json", r"bad\.jsonl:2"),
])
def test_trace_rejects_malformed_lines(tmp_path, line, needle):
    """A malformed line raises naming the file and the line, as the
    reference's loader does on the same file."""
    path = tmp_path / "bad.jsonl"
    path.write_text('{"t": 0.5, "event": "attach", "rid": 1}\n' + line + "\n")
    with pytest.raises(ValueError, match=needle) as got:
        load_trace(str(path))
    with pytest.raises(ValueError) as want:
        ref_load_trace(str(path))
    assert str(got.value) == str(want.value)
    assert "bad.jsonl:2" in str(got.value)


def test_trace_skips_blank_and_comment_lines(tmp_path):
    path = tmp_path / "t.jsonl"
    path.write_text('# preemption log\n\n{"t": 0.5, "event": "detach", "rid": 2, "mode": "drain"}\n')
    assert load_trace(str(path)) == [FaultEvent(0.5, "detach", 2, "drain")]


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1&recover=1", "ws"])
def test_trace_replay_matches_programmatic_injection(spec, tmp_path):
    """A churn run's history, saved and replayed (the fault_trace argument
    and replay_trace), equals injecting the same events by hand, and the
    reference's replay of the same file."""
    sim = Simulator(cholesky_graph(6, 256), paper_machine(4), port_policy(spec), seed=1,
                    noise=0.0, churn=150.0, fault_mode="kill", notice_s=0.001)
    sim.run()
    hist = sim.faults.history
    assert hist and any(e.notice_s for e in hist)
    path = tmp_path / "trace.jsonl"
    save_trace(hist, str(path))
    _, replayed = _pair(spec, seed=1, fault_trace=str(path))
    prog = Simulator(cholesky_graph(6, 256), paper_machine(4), port_policy(spec), seed=1,
                     noise=0.0)
    for e in hist:
        prog.inject(e.event, e.rid, at=e.t, mode=e.mode, notice_s=e.notice_s)
    assert _fp(prog.run()) == _fp(replayed)
    again = Simulator(cholesky_graph(6, 256), paper_machine(4), port_policy(spec), seed=1,
                      noise=0.0)
    again.replay_trace(load_trace(str(path)))
    assert _fp(again.run()) == _fp(replayed)


# ---------------------------------------------------------------------------
# flaky links


def _check_flake(sim, res, retry_max):
    for rec in sim.audit.retries:
        assert 1 <= rec.attempt <= retry_max
    for rec in sim.audit.timeouts:
        assert rec.attempts == retry_max + 1
    assert res.faults["n_retries"] == len(sim.audit.retries)
    assert res.faults["n_timeouts"] == len(sim.audit.timeouts)
    assert sim.audit.result["n_retries"] == res.faults["n_retries"]
    assert errors(verify_audit(sim.audit)) == []


@pytest.mark.parametrize("rate,retry_max", [(0.05, 3), (0.4, 2), (0.9, 0), (0.9, 4)])
@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "ws", "locality"])
def test_flaky_links_match_reference(spec, rate, retry_max):
    """Flaky links: the same retries, backoffs, timeouts and re-sourced
    hops as the reference, every attempt charged, every transfer landed,
    the log clean."""
    sim, res = _pair(spec, seed=9, link_flake=rate, retry_max=retry_max, backoff_s=1e-4,
                     audit=True)
    _check_invariants(sim, res, len(sim.graph))
    _check_flake(sim, res, retry_max)
    assert res.faults["n_retries"] + res.faults["n_timeouts"] > 0
    if retry_max == 0:
        assert res.faults["n_retries"] == 0 and res.faults["n_timeouts"] > 0


def test_flake_stream_is_the_reference_stream():
    sim = Simulator(cholesky_graph(4, 256), paper_machine(2), resolve("heft", device="cpu"),
                    seed=2**32 + 3, link_flake=0.5)
    assert np.array_equal(sim.transfers._flake_rng.random(4),
                          np.random.default_rng((3, 0xF1A4E)).random(4))


@pytest.mark.parametrize("seed", [3, 17, 4242])
def test_flake_churn_and_notice_compose(seed):
    """Flaky links, churn and notices together: exactly-once execution, no
    data lost, a clean log, the reference's run."""
    sim, res = _pair("heft", seed=seed, churn=200.0, fault_mode="kill", notice_s=0.003,
                     link_flake=0.3, retry_max=2, backoff_s=1e-4, audit=True)
    _check_invariants(sim, res, len(sim.graph))
    _check_flake(sim, res, 2)


# ---------------------------------------------------------------------------
# random fault schedules (the property tests' draws, from fixed seeds)


def _schedule(seed, kill_only=False):
    rng = np.random.default_rng(seed)
    events = sorted(
        (float(rng.uniform(0.02, 1.5)), str(rng.choice(["detach", "attach"])),
         int(rng.integers(0, 4)), "kill" if kill_only else str(rng.choice(["drain", "kill"])))
        for _ in range(int(rng.integers(1, 7))))
    return events


@pytest.mark.parametrize("seed", range(12))
def test_random_fault_schedules_match_reference(seed):
    """The property test's schedules (self-consistent: detach only alive
    GPUs, attach only dead ones) on HEFT, DADA+CP (± recover) and ws."""
    spec = ("heft", "dada?alpha=0.5&use_cp=1", "dada?alpha=0.5&use_cp=1&recover=1", "ws")[seed % 4]
    base = _baseline(spec, seed=seed)
    gpus, down, script = _gpus(), set(), []
    for frac, event, gi, mode in _schedule(seed, kill_only=seed % 3 == 2):
        rid = gpus[gi % len(gpus)]
        if (event == "detach") == (rid in down):
            continue
        (down.add if event == "detach" else down.discard)(rid)
        script.append((event, rid, base.makespan * frac, mode if event == "detach" else None,
                       base.makespan * 0.05 if seed % 2 and event == "detach" else None))
    sim, res = _pair(spec, script, seed=seed)
    _check_invariants(sim, res, len(sim.graph))
    assert res.total_flops == cholesky_graph(6, 256).total_flops()


# ---------------------------------------------------------------------------
# the recovery report and claim C8


def test_recovery_report_fields_match_reference():
    base = _baseline("heft")
    sim, faulted = _pair("heft", [("detach", _gpus()[0], base.makespan * 0.3, "kill", None)])
    rep = recovery_report(faulted, base)
    assert rep["baseline_makespan"] == base.makespan and rep["makespan"] == faulted.makespan
    assert rep["recovery_makespan"] == faulted.makespan - base.makespan
    assert rep["slowdown"] == faulted.makespan / base.makespan
    assert rep["extra_bytes"] == faulted.total_bytes - base.total_bytes
    assert rep["n_detaches"] == 1
    assert rep["reactive_evacuated_bytes"] == faulted.faults["evacuated_bytes"]
    ref_base = RefSimulator(ref_cholesky_graph(6, 256, with_fns=False), ref_paper_machine(4),
                            ref_policy("heft"), seed=0, noise=0.0).run()
    ref = RefSimulator(ref_cholesky_graph(6, 256, with_fns=False), ref_paper_machine(4),
                       ref_policy("heft"), seed=0, noise=0.0)
    ref.inject("detach", _gpus()[0], at=ref_base.makespan * 0.3, mode="kill")
    assert ref_recovery_report(ref.run(), ref_base) == rep
    assert recovery_report(base, base) == {
        "makespan": base.makespan, "baseline_makespan": base.makespan, "recovery_makespan": 0.0,
        "slowdown": 1.0, "extra_bytes": 0}


def test_c8_rows_equal_reference():
    """C8's runs (Cholesky NT 16, paper_machine(8), the fault script)
    equal the reference's fault_recovery_runs field for field, verify
    clean, and C8 and both CV rows pass as the reference's do."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks import paper_validation as ref_pv

    reps = pv.fault_recovery_runs("cpu")
    want = ref_pv.fault_recovery_runs()
    assert sorted(reps) == sorted(want) == ["dada", "heft"]
    for label, row in want.items():
        assert {k: reps[label][k] for k in row} == row, label
        assert reps[label]["verify_errors"] == 0
    c8 = pv.check_c8("cpu", reps)
    assert c8["passed"], c8["measured"]
    cv = pv.check_cv("cpu")
    assert [c["passed"] for c in cv] == [True, True], cv
    assert [c["claim"] for c in cv] == [
        "CV exact-engine claim schedules pass the independent verifier",
        "CV surrogate claim schedules pass the independent verifier"]


def test_c8_script_with_a_notice_and_recover():
    """The C8 script with each detach announced ahead, through DADA+CP
    with recover, in both packages: proactive replication, the same run,
    and the port's audited run verifies clean."""
    spec, notice_s = "dada?alpha=0.5&use_cp=1&recover=1", 0.01
    ref_graph, graph = ref_cholesky_graph(16, 512, with_fns=False), cholesky_graph(16, 512)
    base = Simulator(graph, paper_machine(8), port_policy(spec), seed=0, noise=0.0).run()
    ref = RefSimulator(ref_graph, ref_paper_machine(8), ref_policy(spec), seed=0, noise=0.0,
                       notice_s=notice_s)
    port = Simulator(graph, paper_machine(8), port_policy(spec), seed=0, noise=0.0,
                     notice_s=notice_s, audit=True)
    gpus = [r.rid for r in port.machine.gpus]
    for frac, event, gi, mode in pv.C8_FAULTS:
        ref.inject(event, gpus[gi], at=base.makespan * frac, mode=mode)
        port.inject(event, gpus[gi], at=base.makespan * frac, mode=mode)
    ref_res, res = ref.run(), port.run()
    assert _fp(res) == _fp(ref_res)
    rep = recovery_report(res, base)
    assert rep["n_notices"] == 2 and rep["proactive_bytes"] > 0
    assert errors(verify_audit(port.audit)) == []