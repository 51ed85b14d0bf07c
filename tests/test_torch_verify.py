"""The port's audit log and schedule verifier against ``repro.verify``.

- Logs: the port's exact engine with ``audit=True`` writes, for HEFT,
  DADA(0), DADA(0.5)+CP and ``ws`` on Cholesky, LU and QR at NT 6 and 8
  (tile 256) on ``paper_machine(3)`` and ``(8)``, seeds 0 and 7, the
  JSONL that ``repro``'s numpy path writes for the same run, line for
  line, floats exact; and every such log verifies clean. So do faulted
  and flaky runs (churn in drain and kill mode, notices, flaky links,
  scripted detaches and attaches, under a capacity too) of HEFT,
  DADA(0.5)+CP with and without recover, and ``ws``, whose logs also
  serve as bases of the recovery mutation classes.
- Verifier: on the reference's clean logs (capacity-bounded, evicting,
  churned, flaky, noticed, cancel-stale, serving with rejects), read through the
  port's ``from_jsonl``, and on every mutation class of
  ``tests/test_verify_mutations.py`` over those logs and the port's own,
  the port's ``verify_audit`` returns the reference's findings (code,
  severity, message) and flags the class's code. Salts are a fixed list,
  so every run draws the same records.
- Surrogate: ``episode_audit_logs`` over the port's plain scan equals
  the reference's over its compiled scan on the same batch, verifies
  clean, and its mutations are flagged.
- Switches: audit off equals audit on and the reference; ``audit``
  defaults to off; ``run_simulation(audit=True)`` raises on a strategy
  that breaks precedence; the JSONL round trip across both packages keeps
  the verdict and refuses schema drift; the CLI's exit codes.
"""
import copy
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import pytest

from repro.configs.paper_machine import paper_machine as ref_paper_machine
from repro.core import DADA as RefDADA
from repro.core import HEFT as RefHEFT
from repro.core import run_simulation as ref_run_simulation
from repro.core.simulator import Simulator as RefSimulator
from repro.linalg.cholesky import cholesky_graph as ref_cholesky_graph
from repro.linalg.lu import lu_graph as ref_lu_graph
from repro.linalg.qr import qr_graph as ref_qr_graph
from repro.runtime.queues import WorkSteal as RefWorkSteal
from repro.sched import resolve as ref_resolve
from repro.verify import verify_audit as ref_verify_audit
from repro.verify.audit import AuditLog as RefAuditLog
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.core import DADA, HEFT, Simulator, Strategy, run_simulation
from repro_torch.linalg.cholesky import cholesky_graph
from repro_torch.linalg.lu import lu_graph
from repro_torch.linalg.qr import qr_graph
from repro_torch.runtime import Engine
from repro_torch.runtime.queues import WorkSteal
from repro_torch.sched import resolve
from repro_torch.verify import AuditLog, errors, verify_audit
from repro_torch.verify.__main__ import main as verify_main
from repro_torch.verify.schedule import derive_edges

ROOT = Path(__file__).resolve().parent.parent
MB = 1024 * 1024

KERNELS = {
    "cholesky": (ref_cholesky_graph, cholesky_graph),
    "lu": (ref_lu_graph, lu_graph),
    "qr": (ref_qr_graph, qr_graph),
}
STRATEGIES = {
    "heft": (lambda: RefHEFT(backend="numpy"), lambda: HEFT(device="cpu")),
    "dada(0)": (lambda: RefDADA(alpha=0.0, backend="numpy"), lambda: DADA(alpha=0.0, device="cpu")),
    "dada(0.5)+cp": (
        lambda: RefDADA(alpha=0.5, use_cp=True, backend="numpy"),
        lambda: DADA(alpha=0.5, use_cp=True, device="cpu"),
    ),
    "ws": (RefWorkSteal, WorkSteal),
}
# the salts that pick a mutation's record (the reference draws them at
# random from 0..10**6; here they are fixed, so each run checks the same)
SALTS = (0, 1, 7, 42, 999_983)


def _jsonl(log, path):
    log.to_jsonl(str(path))
    return Path(path).read_text().splitlines()


def _fp(res):
    return (
        res.makespan, res.total_bytes, res.n_transfers, tuple(sorted(res.busy.items())),
        tuple((iv.tid, iv.rid, iv.start, iv.end) for iv in res.intervals), res.n_steals,
    )


def _findings(findings):
    return [(f.code, f.severity, f.message) for f in findings]


def _pick(salt, seq):
    assert seq, "no mutation candidates — base log too small"
    return seq[salt % len(seq)]


def _per_graph(log):
    """The result's per-graph entries by integer gid (a log read from JSONL
    keys them by string)."""
    return {int(gid): info for gid, info in log.result["per_graph"].items()}


def _pair(kernel, strat, n_gpus, nt, seed, noise=0.03):
    """The reference's and the port's audited simulators after the run."""
    ref_build, build = KERNELS[kernel]
    ref_fac, fac = STRATEGIES[strat]
    ref = RefSimulator(ref_build(nt, 256, with_fns=False), ref_paper_machine(n_gpus), ref_fac(),
                       seed=seed, noise=noise, audit=True)
    port = Simulator(build(nt, 256), paper_machine(n_gpus), fac(), seed=seed, noise=noise,
                     audit=True)
    return ref, ref.run(), port, port.run()


# ---------------------------------------------------------------------------
# (a) the port's logs are the reference's


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n_gpus", [3, 8])
@pytest.mark.parametrize("nt", [6, 8])
@pytest.mark.parametrize("strat", sorted(STRATEGIES))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_audit_log_equals_reference(kernel, strat, nt, n_gpus, seed, tmp_path):
    ref, ref_res, port, res = _pair(kernel, strat, n_gpus, nt, seed)
    assert _fp(res) == _fp(ref_res)
    want = _jsonl(ref.audit, tmp_path / "ref.jsonl")
    got = _jsonl(port.audit, tmp_path / "port.jsonl")
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"line {i + 1} differs:\n port {a}\n  ref {b}"
    assert len(got) == len(want)
    assert len(port.audit.execs) == len(port.graph) and port.audit.hops and port.audit.landings
    findings = verify_audit(port.audit)
    assert errors(findings) == []
    assert _findings(findings) == _findings(ref_verify_audit(ref.audit))


def test_audit_log_of_two_graphs_equals_reference(tmp_path):
    """Two graphs submitted to one engine: gids, per-graph finishes and the
    machine-global hop stream."""
    from repro.runtime import Engine as RefEngine

    ref = RefEngine(ref_paper_machine(3), RefDADA(alpha=0.5, use_cp=True, backend="numpy"),
                    seed=6, audit=True)
    ref.submit(ref_cholesky_graph(5, 256, with_fns=False))
    ref.submit(ref_lu_graph(4, 256, with_fns=False))
    eng = Engine(paper_machine(3), DADA(alpha=0.5, use_cp=True, device="cpu"), seed=6, audit=True)
    eng.submit(cholesky_graph(5, 256))
    eng.submit(lu_graph(4, 256))
    ref.run(), eng.run()
    assert sorted(eng.audit.graphs) == [0, 1]
    assert _jsonl(eng.audit, tmp_path / "port.jsonl") == _jsonl(ref.audit, tmp_path / "ref.jsonl")
    assert errors(verify_audit(eng.audit)) == []


# ---------------------------------------------------------------------------
# (b) the verifier: the reference's findings on the reference's logs


def _ref_audited(spec="heft", nt=8, n=4, seed=0, **kw):
    sim = RefSimulator(ref_cholesky_graph(nt, 256, with_fns=False), ref_paper_machine(n),
                       ref_resolve(spec), seed=seed, noise=0.0, audit=True, **kw)
    sim.run()
    return sim.audit


def _ref_serving():
    from repro.runtime.load import make_arrivals, run_serving

    out = run_serving(
        make_arrivals("poisson", 16, rate=200.0, seed=1), ref_paper_machine(4), "heft", seed=0,
        admission="reject", mem_capacity=1572864, audit=True,
    )
    return out["engine"].audit


# the reference's clean logs, built as tests/test_verify_schedule.py and
# tests/test_verify_mutations.py build them
REF_LOGS = {
    "capacity-affinity": lambda: _ref_audited(
        "dada?alpha=0.5&use_cp=1", nt=10, mem_capacity=64 * MB, eviction="affinity"),
    "capacity-lru": lambda: _ref_audited(
        "dada?alpha=0.5&use_cp=1", nt=10, mem_capacity=32 * MB, eviction="lru"),
    # capacities at which the memories do evict, with dirty write-backs
    "evicting-affinity": lambda: _ref_audited(
        "dada?alpha=0.5&use_cp=1", nt=10, mem_capacity=8 * MB, eviction="affinity"),
    "evicting-lru": lambda: _ref_audited(
        "dada?alpha=0.5&use_cp=1", nt=10, mem_capacity=8 * MB, eviction="lru"),
    "cancel-stale": lambda: _ref_audited("heft", cancel_stale=True),
    "churn-drain": lambda: _ref_audited("heft", churn=150.0, fault_mode="drain"),
    "churn-kill": lambda: _ref_audited("heft", churn=150.0, fault_mode="kill"),
    "flaky": lambda: _ref_audited("heft", link_flake=0.35, retry_max=2, backoff_s=1e-4),
    "noticed": lambda: _ref_audited("heft", churn=250.0, fault_mode="drain", notice_s=0.004),
    "recovery": lambda: _ref_audited(
        "heft", seed=2, churn=250.0, fault_mode="drain", notice_s=0.004,
        link_flake=0.35, retry_max=2, backoff_s=1e-4),
    "serving": _ref_serving,
}


FAULTED = {  # the port's own faulted runs: the reference's fault settings
    "churn-drain": dict(churn=150.0, fault_mode="drain"),
    "churn-kill": dict(churn=150.0, fault_mode="kill"),
    "flaky": dict(link_flake=0.35, retry_max=2, backoff_s=1e-4),
    "noticed": dict(churn=250.0, fault_mode="drain", notice_s=0.004),
    "recovery": dict(seed=2, churn=250.0, fault_mode="drain", notice_s=0.004, link_flake=0.35,
                     retry_max=2, backoff_s=1e-4),
    "scripted-capacity": dict(mem_capacity=8 * MB, eviction="affinity", notice_s=0.002,
                              script=((0.2, "detach", 0, "kill"), (0.35, "detach", 1, "drain"),
                                      (0.6, "attach", 0, None))),
}
FAULTED_SPECS = ("heft", "dada?alpha=0.5&use_cp=1", "dada?alpha=0.5&use_cp=1&recover=1", "ws")


def _faulted_pair(name, spec):
    """The reference's and the port's audited simulators of one faulted
    run (Cholesky NT 8, tile 256, paper_machine(4), no noise) after it."""
    kw = dict(FAULTED[name])
    seed, script = kw.pop("seed", 0), kw.pop("script", ())
    port_spec = resolve(spec) if spec == "ws" else resolve(spec, device="cpu")
    ref_spec = ref_resolve(spec) if spec == "ws" else ref_resolve(spec, backend="numpy")
    base = RefSimulator(ref_cholesky_graph(8, 256, with_fns=False), ref_paper_machine(4),
                        ref_resolve("heft", backend="numpy"), seed=seed, noise=0.0).run()
    ref = RefSimulator(ref_cholesky_graph(8, 256, with_fns=False), ref_paper_machine(4), ref_spec,
                       seed=seed, noise=0.0, audit=True, **kw)
    port = Simulator(cholesky_graph(8, 256), paper_machine(4), port_spec, seed=seed, noise=0.0,
                     audit=True, **kw)
    gpus = [r.rid for r in port.machine.gpus]
    for frac, event, gi, mode in script:
        for sim in (ref, port):
            sim.inject(event, gpus[gi], at=base.makespan * frac, mode=mode)
    return ref, ref.run(), port, port.run()


@pytest.mark.parametrize("spec", FAULTED_SPECS)
@pytest.mark.parametrize("name", sorted(FAULTED))
def test_faulted_audit_log_equals_reference(name, spec, tmp_path):
    """A faulted or flaky run's log: the port's JSONL is the reference's
    line for line (the fault mode in the machine record, the fault,
    notice, retry and timeout records, the dropped landings, the
    evacuations and the retry counts in the result), and it verifies
    clean with the reference's findings."""
    ref, ref_res, port, res = _faulted_pair(name, spec)
    assert _fp(res) == _fp(ref_res) and res.faults == ref_res.faults
    want = _jsonl(ref.audit, tmp_path / "ref.jsonl")
    got = _jsonl(port.audit, tmp_path / "port.jsonl")
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"line {i + 1} differs:\n port {a}\n  ref {b}"
    assert len(got) == len(want)
    assert port.audit.faults or port.audit.retries
    findings = verify_audit(port.audit)
    assert errors(findings) == []
    assert _findings(findings) == _findings(ref_verify_audit(ref.audit))


def _own_case(spec):
    """The port's own exact log (the mutation tests' base run: HEFT on
    Cholesky NT 8, paper_machine(4), no noise) and the reference's log of
    the same run."""
    ref_fac, fac = STRATEGIES[spec]
    ref = RefSimulator(ref_cholesky_graph(8, 256, with_fns=False), ref_paper_machine(4),
                       ref_fac(), seed=0, noise=0.0, audit=True)
    port = Simulator(cholesky_graph(8, 256), paper_machine(4), fac(), seed=0, noise=0.0,
                     audit=True)
    ref.run(), port.run()
    return ref.audit, port.audit


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """``case(name)``: a pair of logs, built once a module. ``own-<spec>``
    is :func:`_own_case`; any other name a reference log of ``REF_LOGS``
    and the port's reading of its JSONL."""
    root = tmp_path_factory.mktemp("audit_logs")
    built = {}

    def get(name):
        if name not in built:
            if name.startswith("own-"):
                built[name] = _own_case(name[4:])
            elif name.startswith("ownfault-"):
                ref, _, port, _ = _faulted_pair(name[9:], "heft")
                built[name] = (ref.audit, port.audit)
            else:
                ref = REF_LOGS[name]()
                path = root / f"{name}.jsonl"
                ref.to_jsonl(str(path))
                built[name] = (ref, AuditLog.from_jsonl(str(path)))
        return built[name]

    return get


@pytest.mark.parametrize("name", sorted(REF_LOGS))
def test_reference_logs_verify_alike(case, name):
    ref, port = case(name)
    want = ref_verify_audit(ref)
    assert errors(want) == []
    assert _findings(verify_audit(port)) == _findings(want)
    if name == "serving":
        assert port.arrivals and port.admits and port.rejects
    if name in ("flaky", "recovery"):
        assert port.retries
    if name in ("noticed", "recovery"):
        assert port.notices
    if name.startswith("churn"):
        assert port.faults
    if name.startswith(("capacity", "evicting")):
        assert port.machine["capacity"] > 0
    if name.startswith("evicting"):
        assert any(e.dirty for e in port.evictions)
        assert any(h.kind == "writeback" for h in port.hops)


# ---- the mutation classes of tests/test_verify_mutations.py ---------------
# each takes a log (of either package) and a salt, corrupts it in place and
# returns the code the verifier must raise


def _shifted_start(log, salt):
    preds = derive_edges(log.graphs[0]["tasks"])
    exec_of = {r.tid: r for r in log.execs if r.gid == 0}
    candidates = [
        (r, exec_of[p].end)
        for r in log.execs if r.gid == 0
        for p in preds[r.tid]
        if p in exec_of and exec_of[p].end > 1e-6
    ]
    rec, pred_end = _pick(salt, candidates)
    rec.start = pred_end * 0.5 - 1e-3
    return "PRECEDENCE"


def _duplicate_exec(log, salt):
    log.execs.append(copy.deepcopy(_pick(salt, log.execs)))
    return "EXACTLY_ONCE"


def _dropped_exec(log, salt):
    del log.execs[salt % len(log.execs)]
    return "EXACTLY_ONCE"


def _shrunk_hop_bytes(log, salt):
    hop = _pick(salt, [h for h in log.hops if h.nbytes > 1])
    hop.nbytes //= 2
    return "BYTES"


def _inflated_total_bytes(log, salt):
    log.result["total_bytes"] += 12345
    return "BYTES"


def _dropped_hop(log, salt):
    # the byte sum stays, one hop record goes: the n_transfers check fires
    victim = log.hops.pop()
    log.hops[0].nbytes += victim.nbytes
    return "BYTES"


def _dropped_landing(log, salt):
    host = log.machine["host_mem"]
    tasks = log.graphs[0]["tasks"]
    execs = [r for r in log.execs if r.gid == 0]
    writes_at = {(n, r.mem) for r in execs for n, _s, m in tasks[r.tid] if "w" in m}
    candidates = sorted({
        (n, rec.mem)
        for rec in execs if rec.mem != host
        for n, _s, m in tasks[rec.tid]
        if m == "r" and (n, rec.mem) not in writes_at
    })
    name, mem = _pick(salt, candidates)
    before = len(log.landings)
    log.landings = [ld for ld in log.landings
                    if not (ld.gid == 0 and ld.name == name and ld.mem == mem)]
    assert len(log.landings) < before
    return "DATA_ARRIVAL"


def _exec_in_dead_window(log, salt):
    rec = _pick(salt, [r for r in log.execs if r.start > 1e-6])
    log.log_fault(rec.start * 0.9, "detach", rec.rid, "drain")
    log.log_fault(rec.end + 1.0, "attach", rec.rid, None)
    return "DEAD_WINDOW"


def _capacity_overflow(log, salt):
    assert any(h.nbytes > 1 for h in log.hops)
    log.machine["capacity"] = 1
    return "CAPACITY"


def _scaled_finish(log, salt):
    # the reference draws a factor in [1.5, 10]; the salt picks one here
    factor = (1.5, 2.0, 3.25, 7.0, 10.0)[salt % 5]
    _per_graph(log)[0]["finish"] *= factor
    return "MAKESPAN"


def _fabricated_notice(log, salt):
    rec = _pick(salt, [r for r in log.execs if r.start > 1e-3])
    log.log_notice(rec.start * 0.5, rec.rid, "drain", rec.end + 1.0)
    return "NOTICE_GRACE"


def _shifted_start_into_notice(log, salt):
    from bisect import bisect_right

    fault_ts = {}
    for f in log.faults:
        fault_ts.setdefault(f.rid, []).append(f.t)
    for ts in fault_ts.values():
        ts.sort()
    candidates = []
    for note in log.notices:
        ts = fault_ts.get(note.rid, [])
        i = bisect_right(ts, note.t)
        end = ts[i] if i < len(ts) else note.death_at
        if end - note.t < 1e-5:
            continue
        candidates += [(rec, note.t, end) for rec in log.execs if rec.rid == note.rid]
    rec, t0, t1 = _pick(salt, candidates)
    dur = rec.end - rec.start
    rec.start = 0.5 * (t0 + t1)
    rec.end = rec.start + dur
    return "NOTICE_GRACE"


def _dropped_retry(log, salt):
    del log.retries[salt % len(log.retries)]
    return "RETRY_BYTES"


def _shrunk_retry_bytes(log, salt):
    rec = _pick(salt, [r for r in log.retries if r.nbytes > 1])
    rec.nbytes //= 2
    return "RETRY_BYTES"


def _inflated_retry_count(log, salt):
    log.result["n_retries"] += 1
    return "RETRY_BYTES"


def _missing_landing_after_retry(log, salt):
    rec = _pick(salt, log.retries)
    before = len(log.landings)
    log.landings = [
        ld for ld in log.landings
        if not (ld.gid == rec.gid and ld.name == rec.name
                and ld.mem == rec.mem and ld.t >= rec.t - 1e-6)
    ]
    assert len(log.landings) < before, "retried transfer never landed?"
    return "TRANSFER_COMPLETES"


def _exec_before_arrival(log, salt):
    arrive_at = {r.gid: r.t for r in log.arrivals}
    rec = _pick(salt, [r for r in log.execs if arrive_at.get(r.gid, 0.0) > 1e-3])
    rec.start = arrive_at[rec.gid] * 0.5
    return "ARRIVAL"


def _exec_before_admit(log, salt):
    first = {}
    for r in log.execs:
        if r.gid not in first or r.start < first[r.gid].start:
            first[r.gid] = r
    admit = _pick(salt, [a for a in log.admits
                         if a.gid in first and first[a.gid].end > a.t + 1e-3])
    admit.t = first[admit.gid].start + 1e-4
    return "ARRIVAL"


def _fabricated_reject(log, salt):
    already = {r.gid for r in log.rejects}
    gid = _pick(salt, sorted({r.gid for r in log.execs if r.gid not in already}))
    log.log_reject(gid, 0.0, "pressure")
    return "ARRIVAL"


def _tampered_admit_at(log, salt):
    admit_at = {r.gid: r.t for r in log.admits}
    per_graph = _per_graph(log)
    gid = _pick(salt, sorted(g for g, info in per_graph.items()
                             if not info.get("rejected") and admit_at.get(g, 0.0) > 1e-6))
    per_graph[gid]["admit_at"] = admit_at[gid] * 3.0 + 1.0
    return "ARRIVAL"


def _flipped_rejected(log, salt):
    per_graph = _per_graph(log)
    gid = _pick(salt, sorted(g for g, info in per_graph.items() if not info.get("rejected")))
    per_graph[gid]["rejected"] = True
    return "ARRIVAL"


# the exact-engine classes run on the port's own logs and on every clean
# reference log with one graph; the recovery and serving classes on the
# logs that hold their records (as the reference runs them)
EXACT_LOGS = ("own-heft", "own-dada(0.5)+cp", "own-ws", "capacity-affinity", "capacity-lru",
              "evicting-affinity", "evicting-lru", "cancel-stale", "churn-drain", "churn-kill",
              "flaky", "noticed")
SALTED = {
    "shifted_start": (_shifted_start, EXACT_LOGS),
    "duplicate_exec": (_duplicate_exec, EXACT_LOGS),
    "dropped_exec": (_dropped_exec, EXACT_LOGS),
    "shrunk_hop_bytes": (_shrunk_hop_bytes, EXACT_LOGS),
    "dropped_landing": (_dropped_landing, EXACT_LOGS),
    "exec_in_dead_window": (_exec_in_dead_window,
                            EXACT_LOGS + ("ownfault-churn-kill", "ownfault-scripted-capacity")),
    "scaled_finish": (_scaled_finish, EXACT_LOGS),
    "fabricated_notice": (_fabricated_notice, EXACT_LOGS),
    "shifted_start_into_notice": (_shifted_start_into_notice,
                                  ("noticed", "recovery", "ownfault-recovery")),
    "dropped_retry": (_dropped_retry, ("flaky", "recovery", "ownfault-recovery")),
    "shrunk_retry_bytes": (_shrunk_retry_bytes, ("flaky", "recovery", "ownfault-recovery")),
    "missing_landing_after_retry": (_missing_landing_after_retry,
                                    ("flaky", "recovery", "ownfault-recovery")),
    "exec_before_arrival": (_exec_before_arrival, ("serving",)),
    "exec_before_admit": (_exec_before_admit, ("serving",)),
    "fabricated_reject": (_fabricated_reject, ("serving",)),
    "tampered_admit_at": (_tampered_admit_at, ("serving",)),
    "flipped_rejected": (_flipped_rejected, ("serving",)),
}
UNSALTED = {
    "inflated_total_bytes": (_inflated_total_bytes, EXACT_LOGS + ("serving",)),
    "dropped_hop": (_dropped_hop, EXACT_LOGS + ("serving",)),
    "capacity_overflow": (_capacity_overflow, EXACT_LOGS),
    "inflated_retry_count": (_inflated_retry_count, ("flaky", "recovery", "ownfault-recovery")),
}
MUTATION_CASES = (
    [(m, log, salt) for m, (_, logs) in SALTED.items() for log in logs for salt in SALTS]
    + [(m, log, 0) for m, (_, logs) in UNSALTED.items() for log in logs]
)


@pytest.mark.parametrize("mutation,log,salt", MUTATION_CASES)
def test_mutation_flagged_like_reference(case, mutation, log, salt):
    fn = {**SALTED, **UNSALTED}[mutation][0]
    ref, port = (copy.deepcopy(x) for x in case(log))
    code = fn(ref, salt)
    assert fn(port, salt) == code
    got = verify_audit(port)
    assert _findings(got) == _findings(ref_verify_audit(ref))
    assert code in {f.code for f in errors(got)}


# ---------------------------------------------------------------------------
# (c) the surrogate: episode_audit_logs over the port's scan


SURROGATE_SPECS = ("heft", "dada?alpha=0.5&use_cp=1", "ws")


@lru_cache(maxsize=None)
def _surrogate(kind):
    """The port's plain scan and the reference's compiled scan (its jnp
    fold) on one batch: NT 6, 2 and 8 GPUs, three specs, two seeds. Returns
    both packages' audit logs, one per configuration."""
    pytest.importorskip("jax")
    from _episode_cases import configs, plan_and_batch

    from repro.core import episode as ref_ep
    from repro.sched.config import SchedConfig
    from repro_torch.core import episode as ep

    ref_build, build = KERNELS[kind]
    items = configs(build(6, 256), (2, 8), SURROGATE_SPECS, (1234, 1235))
    plan, batch = plan_and_batch(items)
    out = ep.run_episodes(plan, batch, device="cpu", emit_schedule=True)
    ref_graph = ref_build(6, 256, with_fns=False)
    ref_plan = ref_ep.build_plan(ref_graph, ref_paper_machine(2), n_u=plan.n_u)
    ref_out = ref_ep.run_episodes(ref_plan, batch, config=SchedConfig(backend="jax", pallas="0"),
                                  emit_schedule=True)
    return (ref_ep.episode_audit_logs(ref_graph, batch, ref_out),
            ep.episode_audit_logs(build(6, 256), batch, out))


@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_surrogate_logs_equal_reference_and_verify_clean(kind, tmp_path):
    ref_logs, logs = _surrogate(kind)
    assert len(logs) == len(ref_logs) == 2 * len(SURROGATE_SPECS) * 2
    for b, (ref, log) in enumerate(zip(ref_logs, logs)):
        assert log.engine == "surrogate" and len(log.execs) == len(log.graphs[0]["tasks"])
        assert log.hops
        got = _jsonl(log, tmp_path / f"port{b}.jsonl")
        assert got == _jsonl(ref, tmp_path / f"ref{b}.jsonl"), b
        findings = verify_audit(log)
        assert errors(findings) == [], b
        assert _findings(findings) == _findings(ref_verify_audit(ref))
        # the JSONL reads back into the port with the same verdict
        back = AuditLog.from_jsonl(str(tmp_path / f"port{b}.jsonl"))
        assert _findings(verify_audit(back)) == _findings(findings)


def _surrogate_precedence(log, salt):
    preds = derive_edges(log.graphs[0]["tasks"])
    exec_of = {r.tid: r for r in log.execs}
    candidates = [(r, exec_of[p].end) for r in log.execs for p in preds[r.tid]
                  if p in exec_of and exec_of[p].end > 1e-4]
    rec, _ = _pick(salt, candidates)
    rec.start = -1.0  # unambiguously before any predecessor in f32
    return "PRECEDENCE"


def _surrogate_dead_device(log, salt):
    rec = _pick(salt, log.execs)
    for r in log.machine["resources"]:
        if r["rid"] == rec.rid:
            r["valid"] = False
    return "RESOURCE_VALID"


def _surrogate_bytes(log, salt):
    log.result["total_bytes"] *= 2.0
    return "BYTES"


@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("mutation", [_surrogate_precedence, _surrogate_dead_device,
                                      _surrogate_bytes], ids=["precedence", "dead_device", "bytes"])
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_surrogate_mutation_flagged_like_reference(kind, mutation, salt):
    ref_logs, logs = _surrogate(kind)
    b = salt % len(logs)  # the salt also picks the configuration
    ref, log = copy.deepcopy(ref_logs[b]), copy.deepcopy(logs[b])
    code = mutation(ref, salt)
    assert mutation(log, salt) == code
    got = verify_audit(log)
    assert _findings(got) == _findings(ref_verify_audit(ref))
    assert code in {f.code for f in errors(got)}


# ---------------------------------------------------------------------------
# (d) the switches


@pytest.mark.parametrize("strat", sorted(STRATEGIES))
def test_audit_is_observational(strat):
    """Audit off, audit on and the reference give the same result bit for
    bit, and an audit-off engine holds no log."""
    ref_fac, fac = STRATEGIES[strat]
    ref = ref_run_simulation(ref_qr_graph(6, 256, with_fns=False), ref_paper_machine(4),
                             ref_fac(), seed=3)
    off = Simulator(qr_graph(6, 256), paper_machine(4), fac(), seed=3)
    on = Simulator(qr_graph(6, 256), paper_machine(4), fac(), seed=3, audit=True)
    assert off.audit is None and off.transfers.audit is None
    assert on.audit is not None and on.transfers.audit is on.audit
    assert _fp(off.run()) == _fp(on.run()) == _fp(ref)
    assert len(on.audit.execs) == len(on.graph)


def test_audit_defaults_off():
    import inspect

    assert Simulator(cholesky_graph(4, 256), paper_machine(2), HEFT(device="cpu")).audit is None
    assert Engine(paper_machine(2), HEFT(device="cpu")).audit is None
    assert inspect.signature(run_simulation).parameters["audit"].default is False


class _AllAtOnce(Strategy):
    """A broken strategy: pushes every task of the graph when the roots are
    placed, round robin over the CPUs, whether its predecessors ran or
    not (their inputs sit on the host, so nothing holds them back), and
    ignores every later activation."""

    name = "all-at-once"

    def place(self, sim, ready, src):
        if src is None:
            cpus = [r.rid for r in sim.machine.cpus]
            for t in sim.graph.tasks:
                sim.push(t, cpus[t.tid % len(cpus)])


def test_run_simulation_raises_on_a_broken_schedule():
    res = run_simulation(cholesky_graph(4, 256), paper_machine(2), _AllAtOnce(), seed=0)
    assert sorted(iv.tid for iv in res.intervals) == list(range(len(cholesky_graph(4, 256))))
    with pytest.raises(RuntimeError, match=r"schedule verification failed \(\d+ error\(s\)\): "
                                           r"PRECEDENCE"):
        run_simulation(cholesky_graph(4, 256), paper_machine(2), _AllAtOnce(), seed=0, audit=True)
    # a sound strategy passes under audit and returns the audit-off result
    on = run_simulation(cholesky_graph(6, 256), paper_machine(4), HEFT(device="cpu"), seed=1,
                        audit=True)
    off = run_simulation(cholesky_graph(6, 256), paper_machine(4), HEFT(device="cpu"), seed=1)
    assert _fp(on) == _fp(off)


def test_jsonl_round_trip_across_packages(tmp_path):
    """A port log reads back in both packages, record for record, with the
    verdict unchanged; a reference log reads back in the port."""
    _, _, port, _ = _pair("lu", "dada(0.5)+cp", 3, 6, 0)
    path = tmp_path / "audit.jsonl"
    port.audit.to_jsonl(str(path))
    back, ref_back = AuditLog.from_jsonl(str(path)), RefAuditLog.from_jsonl(str(path))
    for log in (back, ref_back):
        assert log.engine == "exact" and log.machine == json.loads(json.dumps(port.audit.machine))
        assert [tuple(vars(r).values()) for r in log.execs] == [
            tuple(vars(r).values()) for r in port.audit.execs]
        assert len(log.hops) == len(port.audit.hops)
        assert len(log.landings) == len(port.audit.landings)
    direct = _findings(verify_audit(port.audit))
    assert _findings(verify_audit(back)) == direct == _findings(ref_verify_audit(ref_back))
    again = tmp_path / "again.jsonl"
    back.to_jsonl(str(again))
    assert again.read_text() == path.read_text()


def test_jsonl_rejects_schema_drift(tmp_path):
    _, _, port, _ = _pair("cholesky", "heft", 2, 4, 0)
    path = tmp_path / "audit.jsonl"
    lines = _jsonl(port.audit, path)
    path.write_text("\n".join([lines[0].replace('"schema": 1', '"schema": 99')] + lines[1:]))
    with pytest.raises(ValueError, match="audit.jsonl:1: unsupported audit schema"):
        AuditLog.from_jsonl(str(path))
    path.write_text("\n".join(lines[:2] + ['{"type": "exec", "seq": 1, "gid": 0}']))
    with pytest.raises(ValueError, match="audit.jsonl:3: bad exec record"):
        AuditLog.from_jsonl(str(path))
    path.write_text("\n".join(lines[:1] + ['{"type": "bogus"}']))
    with pytest.raises(ValueError, match="audit.jsonl:2: unknown record type 'bogus'"):
        AuditLog.from_jsonl(str(path))


def _cli_logs(tmp_path):
    _, _, port, _ = _pair("cholesky", "heft", 2, 5, 0)
    clean = tmp_path / "clean.jsonl"
    port.audit.to_jsonl(str(clean))
    bad = copy.deepcopy(port.audit)
    _duplicate_exec(bad, 3)
    broken = tmp_path / "broken.jsonl"
    bad.to_jsonl(str(broken))
    unreadable = tmp_path / "unreadable.jsonl"
    unreadable.write_text("{not json\n")
    return clean, broken, unreadable


def test_cli_exit_codes(tmp_path, capsys):
    clean, broken, unreadable = _cli_logs(tmp_path)
    assert verify_main(["schedule", str(clean)]) == 0
    assert "engine=exact 0 error(s)" in capsys.readouterr().out
    assert verify_main(["schedule", str(broken)]) == 1
    assert "EXACTLY_ONCE" in capsys.readouterr().out
    assert verify_main(["schedule", str(unreadable)]) == 1
    assert "unreadable audit log" in capsys.readouterr().out
    # one bad log among clean ones fails the whole call
    assert verify_main(["schedule", str(clean), str(broken), str(clean)]) == 1


def test_cli_as_a_module(tmp_path):
    clean, broken, unreadable = _cli_logs(tmp_path)
    codes = []
    for path in (clean, broken, unreadable):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.verify", "schedule", str(path)],
            cwd=tmp_path, capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        )
        codes.append(proc.returncode)
    assert codes == [0, 1, 1]
