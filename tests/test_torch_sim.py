"""The slice as a whole: the port's simulations against ``repro``'s.

The port's ``run_simulation`` fingerprint (makespan, bytes, transfers,
busy times, every execution interval) equals ``repro``'s numpy-path
fingerprint over the matrix of ``tests/test_backend.py`` — {cholesky, lu,
qr} × {heft, dada(0), dada(0.5), dada(0.5)+cp} × {0, 3, 8} GPUs × seeds
{0, 7} at NT 6, tile 256 — with every activation scored by the backend
(``min_wide=1``), and so does the work-stealing baseline ``ws``, steals
counted. So do the accepted λ and loads, the graph builders
(task by task), the reference's random graphs and machines brought across
by ``repro_torch.convert``, the host path (``min_wide`` above every
activation) and a two-graph engine run."""
import numpy as np
import pytest

from repro.configs.paper_machine import CPU_CLASS as REF_CPU_CLASS
from repro.configs.paper_machine import GPU_CLASS as REF_GPU_CLASS
from repro.configs.paper_machine import paper_machine as ref_paper_machine
from repro.core import DADA as RefDADA
from repro.core import HEFT as RefHEFT
from repro.core import run_simulation as ref_run_simulation
from repro.core.machine import make_machine as ref_make_machine
from repro.runtime.queues import WorkSteal as RefWorkSteal
from repro.linalg.cholesky import cholesky_graph as ref_cholesky_graph
from repro.linalg.lu import lu_graph as ref_lu_graph
from repro.linalg.qr import qr_graph as ref_qr_graph
from repro_torch.configs.paper_machine import paper_machine
from repro_torch.convert import graph_from_spec, machine_from_spec
from repro_torch.core import DADA, HEFT, run_simulation
from repro_torch.linalg.cholesky import cholesky_graph
from repro_torch.linalg.lu import lu_graph
from repro_torch.linalg.qr import qr_graph
from repro_torch.runtime.queues import WorkSteal
from repro_torch.sched import resolve

KERNELS = {
    "cholesky": (ref_cholesky_graph, cholesky_graph),
    "lu": (ref_lu_graph, lu_graph),
    "qr": (ref_qr_graph, qr_graph),
}

STRATEGIES = {
    "heft": (lambda: RefHEFT(backend="numpy"), lambda **kw: HEFT(**kw)),
    "dada(0)": (lambda: RefDADA(alpha=0.0, backend="numpy"), lambda **kw: DADA(alpha=0.0, **kw)),
    "dada(0.5)": (lambda: RefDADA(alpha=0.5, backend="numpy"), lambda **kw: DADA(alpha=0.5, **kw)),
    "dada(0.5)+cp": (
        lambda: RefDADA(alpha=0.5, use_cp=True, backend="numpy"),
        lambda **kw: DADA(alpha=0.5, use_cp=True, **kw),
    ),
    # ws scores nothing: it takes no device and no min_wide
    "ws": (RefWorkSteal, lambda **kw: WorkSteal()),
}


def _fingerprint(res):
    return (
        res.makespan,
        res.total_bytes,
        res.n_transfers,
        tuple(sorted(res.busy.items())),
        tuple((iv.tid, iv.rid, iv.start, iv.end) for iv in res.intervals),
        res.n_steals,
    )


def _ref_fingerprint(res):
    if res.strategy != "ws":
        assert res.n_steals == 0  # HEFT and DADA place every task; none steal
    return _fingerprint(res)


def graph_spec(graph):
    """A plain description of a ``repro`` graph (repro_torch.convert)."""
    return [
        {
            "kind": t.kind, "flops": t.flops, "tag": t.tag,
            "accesses": [(a.data.name, a.data.size_bytes, a.mode.value) for a in t.accesses],
        }
        for t in graph.tasks
    ]


def machine_spec(machine):
    """A plain description of a ``repro`` machine (repro_torch.convert)."""
    return {
        "classes": {
            c.name: {"rates": dict(c.rates), "default_rate": c.default_rate}
            for c in machine.classes()
        },
        "resources": [(r.cls.name, r.mem, r.link) for r in machine.resources],
        "bandwidth": machine.link.bandwidth,
        "latency": machine.link.latency,
    }


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n_gpus", [0, 3, 8])
@pytest.mark.parametrize("strat", sorted(STRATEGIES))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_port_matches_reference(kernel, strat, n_gpus, seed):
    ref_build, build = KERNELS[kernel]
    ref_fac, fac = STRATEGIES[strat]
    a = ref_run_simulation(
        ref_build(6, 256, with_fns=False), ref_paper_machine(n_gpus), ref_fac(), seed=seed
    )
    b = run_simulation(
        build(6, 256), paper_machine(n_gpus), fac(device="cpu", min_wide=1), seed=seed
    )
    assert _fingerprint(b) == _ref_fingerprint(a)
    assert b.strategy == a.strategy
    assert b.total_flops == a.total_flops and b.n_events == a.n_events
    assert (b.gflops, b.gbytes) == (a.gflops, a.gbytes)
    if strat == "ws":
        assert b.n_steals > 0  # steals happen on every machine here, 0 GPUs included


def test_ws_two_graphs_like_reference():
    """Steal rounds across two submitted graphs: a thief may take the other
    graph's task, and the LIFO owner pop reheads across graphs."""
    from repro.runtime import Engine as RefEngine
    from repro_torch.runtime import Engine

    ref_eng = RefEngine(ref_paper_machine(4), RefWorkSteal(), seed=11)
    ref_eng.submit(ref_cholesky_graph(5, 256, with_fns=False))
    ref_eng.submit(ref_qr_graph(4, 256, with_fns=False))
    eng = Engine(paper_machine(4), WorkSteal(), seed=11)
    eng.submit(cholesky_graph(5, 256))
    eng.submit(qr_graph(4, 256))
    ref_res, res = ref_eng.run(), eng.run()
    assert [_fingerprint(r) for r in res] == [_fingerprint(r) for r in ref_res]
    assert res[0].n_steals > 0


def test_lambda_and_loads_match():
    """The accepted λ and the final per-resource loads drive the
    mid-simulation load_ts corrections: they match too."""
    a = RefDADA(alpha=0.5, backend="numpy")
    b = DADA(alpha=0.5, device="cpu")
    ref_run_simulation(ref_cholesky_graph(6, 256, with_fns=False), ref_paper_machine(4), a, seed=3)
    run_simulation(cholesky_graph(6, 256), paper_machine(4), b, seed=3)
    assert a.last_lambda == b.last_lambda
    assert a.last_loads == b.last_loads


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("n_tiles", [1, 5, 9])
def test_graph_builders_match_reference(kernel, n_tiles):
    ref_build, build = KERNELS[kernel]
    ref_g, g = ref_build(n_tiles, 384, with_fns=False), build(n_tiles, 384)
    assert graph_spec(g) == graph_spec(ref_g)
    assert g.succ == ref_g.succ and g.pred == ref_g.pred
    assert [a.data.meta for t in g.tasks for a in t.accesses] == [
        a.data.meta for t in ref_g.tasks for a in t.accesses
    ]


def _random_graph(seed: int, n_tasks: int = 40, n_data: int = 10):
    """The random graphs of tests/test_residency_property.py."""
    from repro.core import DataObject, Mode, TaskGraph

    rng = np.random.default_rng(seed)
    datas = [
        DataObject(f"x{i}", int(rng.integers(1_000, 150_000)))
        for i in range(n_data)
    ]
    g = TaskGraph()
    for _ in range(n_tasks):
        k = int(rng.integers(1, 4))
        picks = rng.choice(n_data, size=k, replace=False)
        accesses = []
        for j, di in enumerate(picks):
            mode = Mode.RW if j == 0 else (
                Mode.R if rng.random() < 0.6 else Mode.W
            )
            accesses.append((datas[di], mode))
        g.add_task(
            f"kind{int(rng.integers(3))}", accesses,
            flops=float(rng.uniform(1e6, 1e8)),
        )
    return g


@pytest.mark.parametrize("spec", ["heft", "dada?alpha=0.5&use_cp=1", "dada?alpha=0.25"])
@pytest.mark.parametrize("seed", [3, 28, 1234])
def test_random_graphs_through_convert(seed, spec):
    ref_g = _random_graph(seed)
    from repro.sched import resolve as ref_resolve

    a = ref_run_simulation(ref_g, ref_paper_machine(3), ref_resolve(spec, backend="numpy"), seed=seed)
    g = graph_from_spec(graph_spec(ref_g))
    m = machine_from_spec(machine_spec(ref_paper_machine(3)))
    b = run_simulation(g, m, resolve(spec, device="cpu"), seed=seed)
    assert _fingerprint(b) == _ref_fingerprint(a)


@pytest.mark.parametrize("strat", sorted(STRATEGIES))
def test_all_gpu_machine_through_convert(strat):
    """No CPU worker at all (4 cores pinned by 4 GPUs): no host column."""
    ref_m = ref_make_machine(4, 4, REF_CPU_CLASS, REF_GPU_CLASS, gpu_pins_cpu=True)
    ref_fac, fac = STRATEGIES[strat]
    a = ref_run_simulation(ref_cholesky_graph(6, 256, with_fns=False), ref_m, ref_fac(), seed=2)
    b = run_simulation(
        cholesky_graph(6, 256), machine_from_spec(machine_spec(ref_m)), fac(device="cpu"), seed=2
    )
    assert _fingerprint(b) == _ref_fingerprint(a)


@pytest.mark.parametrize("affinity", ["write_resident", "all_resident", "accel_all"])
def test_nondefault_affinity(affinity):
    a = ref_run_simulation(
        ref_cholesky_graph(6, 256, with_fns=False), ref_paper_machine(3),
        RefDADA(alpha=0.75, affinity=affinity, backend="numpy"), seed=9,
    )
    b = run_simulation(
        cholesky_graph(6, 256), paper_machine(3),
        DADA(alpha=0.75, affinity=affinity, device="cpu"), seed=9,
    )
    assert _fingerprint(b) == _ref_fingerprint(a)


def test_area_bound():
    a = ref_run_simulation(
        ref_lu_graph(5, 256, with_fns=False), ref_paper_machine(4),
        RefDADA(alpha=0.5, area_bound=True, backend="numpy"), seed=1,
    )
    b = run_simulation(
        lu_graph(5, 256), paper_machine(4), resolve("dada?alpha=0.5&area_bound=1", device="cpu"), seed=1,
    )
    assert _fingerprint(b) == _ref_fingerprint(a)


@pytest.mark.parametrize("strat", ["heft", "dada(0.5)+cp"])
@pytest.mark.parametrize("min_wide", [4, 10**9])
def test_host_path_and_mixed_widths(strat, min_wide):
    """min_wide above some (or every) activation: the host rows score
    those activations, and the result does not change."""
    ref_fac, fac = STRATEGIES[strat]
    a = ref_run_simulation(ref_qr_graph(7, 256, with_fns=False), ref_paper_machine(8), ref_fac(), seed=4)
    b = run_simulation(qr_graph(7, 256), paper_machine(8), fac(device="cpu", min_wide=min_wide), seed=4)
    assert _fingerprint(b) == _ref_fingerprint(a)


def test_engine_runs_two_graphs_like_reference():
    from repro.runtime import Engine as RefEngine
    from repro_torch.runtime import Engine

    ref_eng = RefEngine(ref_paper_machine(3), RefDADA(alpha=0.5, use_cp=True, backend="numpy"), seed=6)
    ref_eng.submit(ref_cholesky_graph(5, 256, with_fns=False))
    ref_eng.submit(ref_lu_graph(4, 256, with_fns=False))
    eng = Engine(paper_machine(3), DADA(alpha=0.5, use_cp=True, device="cpu"), seed=6)
    eng.submit(cholesky_graph(5, 256))
    eng.submit(lu_graph(4, 256))
    ref_res, res = ref_eng.run(), eng.run()
    assert [_fingerprint(r) for r in res] == [_ref_fingerprint(r) for r in ref_res]


def test_registry_specs_build_the_direct_objects():
    s = resolve("dada?alpha=0.25&use_cp=1&min_wide=32", device="cpu")
    assert isinstance(s, DADA) and s.alpha == 0.25 and s.use_cp and s.min_wide == 32
    assert s.name == "dada(0.25)+cp"
    assert resolve("heft?device=cpu").name == "heft"
    assert resolve("dual?use_cp=1", device="cpu").name == "dual+cp"
    for bad in ["nope", "dada?alpha=x", "dada?use_cp=maybe", "dada?bogus=1", "dada?alpha=0.1&alpha=0.2"]:
        with pytest.raises(ValueError):
            resolve(bad, device="cpu")
    with pytest.raises(ValueError, match="min_wide"):
        HEFT(device="cpu", min_wide=0)


@pytest.mark.parametrize("make", [
    lambda: HEFT(),
    lambda: DADA(alpha=0.5, use_cp=True),
    lambda: resolve("dada?alpha=0.5&use_cp=1"),
    lambda: resolve("heft"),
    lambda: resolve("locality"),
    lambda: resolve("priority"),
    lambda: resolve("wfq?min_wide=8"),
])
def test_entry_points_demand_the_card(make, monkeypatch):
    """Without device="cpu" a strategy is built for the card, and on a
    machine without one construction raises instead of quietly running
    the plain CPU versions."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
