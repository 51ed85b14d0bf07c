"""Public entry points of the scheduling core: the exact simulation, the
paper's seeded repetitions over it (``run_many``) and the batched
surrogate episodes."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..device import resolve_device
from ..sched.registry import resolve
from ..verify import errors, verify_audit
from .dag import TaskGraph
from .machine import MachineModel
from .simulator import SimResult, Simulator


def run_simulation(
    graph: TaskGraph,
    machine: MachineModel,
    strategy,
    seed: int = 0,
    noise: float = 0.03,
    audit: bool = False,
) -> SimResult:
    """Simulate ``graph`` on ``machine`` under ``strategy`` (a strategy
    object, or a registry spec such as ``"dada?alpha=0.5&use_cp=1"``,
    which builds it for the card).

    ``audit=True`` records the run's audit log and re-checks it with the
    independent verifier (:func:`repro_torch.verify.verify_audit`):
    precedence, data arrival, byte conservation, exactly-once execution,
    the makespan. Any error raises ``RuntimeError``."""
    sim = Simulator(graph, machine, resolve(strategy), seed=seed, noise=noise, audit=audit)
    res = sim.run()
    if sim.audit is not None:
        errs = errors(verify_audit(sim.audit))
        if errs:
            detail = "; ".join(f"{f.code}: {f.message}" for f in errs[:5])
            raise RuntimeError(
                f"schedule verification failed ({len(errs)} error(s)): {detail}"
            )
    return res


@dataclass
class Summary:
    """Mean + 95% confidence interval over repeated runs (paper methodology:
    >=30 runs per configuration, mean and 95% CI reported)."""

    strategy: str
    n: int
    gflops_mean: float
    gflops_ci95: float
    gbytes_mean: float
    gbytes_ci95: float
    makespan_mean: float
    steals_mean: float

    def row(self) -> str:
        return (
            f"{self.strategy},{self.n},{self.gflops_mean:.2f},{self.gflops_ci95:.2f},"
            f"{self.gbytes_mean:.3f},{self.gbytes_ci95:.3f},{self.makespan_mean:.4f},"
            f"{self.steals_mean:.1f}"
        )


def ci95(xs: Sequence[float]) -> float:
    """Half-width of the normal 95% confidence interval of the mean."""
    if len(xs) < 2:
        return 0.0
    return 1.96 * float(np.std(xs, ddof=1)) / math.sqrt(len(xs))


_GRAPH_CACHE: Dict[tuple, TaskGraph] = {}


def cached_graph(factory) -> TaskGraph:
    """Memoize graphs built by ``functools.partial`` factories.

    A sweep runs many (strategy × machine) configurations over the *same*
    kernel graph; within one process the graph and its structure-of-arrays
    view are built once per distinct factory signature instead of once per
    configuration. Eviction is LRU one at a time (16 graphs). Non-partial
    factories (closures, lambdas) are not memoized.
    """
    try:
        key = (factory.func, factory.args, tuple(sorted(factory.keywords.items())))
        hash(key)
    except (AttributeError, TypeError):
        return factory()
    g = _GRAPH_CACHE.get(key)
    if g is None:
        while len(_GRAPH_CACHE) >= 16:
            _GRAPH_CACHE.pop(next(iter(_GRAPH_CACHE)))
        _GRAPH_CACHE[key] = g = factory()
    else:
        # refresh recency so steady sweep graphs outlive one-off builds
        _GRAPH_CACHE.pop(key)
        _GRAPH_CACHE[key] = g
    return g


def run_many(
    graph_factory,
    machine: MachineModel,
    strategy_factory,
    n_runs: int = 30,
    noise: float = 0.03,
    base_seed: int = 1234,
    audit: bool = False,
) -> Summary:
    """Run ``n_runs`` seeded simulations (seeds ``base_seed + i``) and
    summarize them: mean and 95% CI. ``audit=True`` records every run and
    re-checks it with the verifier (:func:`run_simulation`'s ``audit``:
    an error raises), as the reference does for every sweep run under its
    audit switch.

    ``graph_factory`` and ``strategy_factory`` are callables so each run
    gets a fresh strategy (the history model calibrates within a run); the
    graph is shared through :func:`cached_graph`. The runs go one after
    another in this process: a strategy built for the card holds a CUDA
    context, which a forked worker cannot use. The reference's process
    pool gives the same summary for any worker count, so nothing is lost.
    """
    graph = cached_graph(graph_factory)
    gf, gb, mk, st = [], [], [], []
    name = ""
    for i in range(n_runs):
        strat = strategy_factory()
        res = run_simulation(graph, machine, strat, seed=base_seed + i, noise=noise, audit=audit)
        gf.append(res.gflops)
        gb.append(res.gbytes)
        mk.append(res.makespan)
        st.append(float(res.n_steals))
        name = strat.name
    return Summary(
        strategy=name,
        n=n_runs,
        gflops_mean=float(np.mean(gf)),
        gflops_ci95=ci95(gf),
        gbytes_mean=float(np.mean(gb)),
        gbytes_ci95=ci95(gb),
        makespan_mean=float(np.mean(mk)),
        steals_mean=float(np.mean(st)),
    )


@dataclass(frozen=True)
class BatchResult:
    """One configuration's surrogate-episode outcome.

    Mirrors the :class:`SimResult` metric surface (``gflops`` / ``gbytes``
    derived the same way) so sweep code can consume either engine's
    results through one row schema. ``n_placed`` counts the tasks the
    episode placed (all of them, in a finished episode).
    """

    strategy: str
    seed: int
    makespan: float
    total_bytes: float
    total_flops: float
    n_steals: int = 0
    n_placed: int = 0

    @property
    def gflops(self) -> float:
        if self.makespan <= 0:
            return 0.0
        return self.total_flops / self.makespan / 1e9

    @property
    def gbytes(self) -> float:
        return self.total_bytes / 1e9


def run_batch(configs: Sequence[dict], device="cuda") -> List[BatchResult]:
    """Run a batch of scheduling configurations through the surrogate
    episode engine, one episode scan per group.

    Each item of ``configs`` is a mapping::

        {"graph": TaskGraph | partial-factory, "machine": MachineModel,
         "strategy": "dada?alpha=0.5&use_cp=1",  # heft | ws | dada | dual
         "seed": 1234, "noise": 0.03, "capacity": 0}

    Items are grouped by (graph, machine template) — machine *shapes*
    (GPU counts), strategy parameters, seeds and capacities are batch
    axes inside a group. On the card each group is one launch of the
    ``episode_scan`` kernel; with ``device="cpu"`` the plain scan takes
    the group whole. Configurations never interact, so results do not
    depend on the grouping; they come back in input order.

    This is the approximate engine (see :mod:`repro_torch.core.episode`):
    use it for sweeps and searches, and :func:`run_simulation` for
    verification.
    """
    from . import episode as ep

    dev = resolve_device(device)
    items = []
    for i, c in enumerate(configs):
        g = c["graph"]
        if not isinstance(g, TaskGraph):
            g = cached_graph(g)
        items.append((i, g, c))

    groups: Dict[tuple, list] = {}
    for i, g, c in items:
        m: MachineModel = c["machine"]
        cpu = next((r.cls for r in m.resources if not r.is_accelerator), None)
        gpu = next((r.cls for r in m.resources if r.is_accelerator), None)
        key = (
            id(g), len(m.resources),
            cpu.name if cpu else None, gpu.name if gpu else None,
            m.link.bandwidth, m.link.latency,
        )
        groups.setdefault(key, []).append((i, g, c))

    out: List[Optional[BatchResult]] = [None] * len(items)
    for group in groups.values():
        g = group[0][1]
        max_mem = max(
            max((r.mem for r in c["machine"].resources if r.is_accelerator), default=-1)
            for _, _, c in group
        )
        plan = ep.build_plan(g, group[0][2]["machine"], n_u=max_mem + 2)
        batch = ep.config_batch(plan, [c for _, _, c in group])
        res = ep.run_episodes(plan, batch, device=dev)
        for j, (i, _, c) in enumerate(group):
            out[i] = BatchResult(
                strategy=c["strategy"],
                seed=int(c.get("seed", 0)),
                makespan=float(res["makespan"][j]),
                total_bytes=float(res["total_bytes"][j]),
                total_flops=plan.total_flops,
                n_placed=int(res["n_placed"][j]),
            )
    return out  # type: ignore[return-value]
