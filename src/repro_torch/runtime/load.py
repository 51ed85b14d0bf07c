"""Open-loop serving load: seeded arrival generators, JSONL arrival traces
and the serving driver.

Counterpart of ``repro.runtime.load``. Tenant graphs stream into a live
:class:`~repro_torch.runtime.engine.Engine` as an open-loop arrival
process (arrivals do not wait for completions). Three seeded generators,
each on a stream of its own:

  * ``poisson``: memoryless arrivals at a constant rate;
  * ``bursty``: on/off modulated, tight gaps inside a burst, long quiet
    periods between bursts;
  * ``diurnal``: a sinusoidally modulated rate, sampled by thinning.

An arrival trace is JSONL, one ``{"t": <seconds>, "kind": <catalog key>,
"tenant": <id>, "priority": <float, optional>}`` a line; blank and
comment lines are skipped and a malformed line is refused with its
``path:lineno``.

:func:`run_serving` submits every arrival against a graph catalog, runs a
serving engine (its pool's rows scored on ``device``) and reports each
tenant's makespan, slowdown against the empty-machine baseline and
queueing delay, with the p50 / p99 and fairness aggregates of
:func:`repro_torch.runtime.metrics.serving_report`.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

ARRIVAL_PROCESSES = ("poisson", "bursty", "diurnal")
ADMISSION_MODES = ("none", "reject", "defer")

# each generator's stream key: poisson(seed=0) and bursty(seed=0) never alias
_POISSON_STREAM = 0x10AD01
_BURSTY_STREAM = 0x10AD02
_DIURNAL_STREAM = 0x10AD03
_KIND_STREAM = 0x10AD04


@dataclass(frozen=True)
class Arrival:
    """One tenant arrival: when, which graph kind, who, how important."""

    t: float
    kind: str
    tenant: int
    priority: float = 1.0

    def __post_init__(self) -> None:
        if not (self.t >= 0.0):
            raise ValueError(f"arrival time must be >= 0, got {self.t!r}")
        if not isinstance(self.kind, str) or not self.kind:
            raise ValueError(f"arrival kind must be a non-empty string, got {self.kind!r}")
        if self.tenant < 0:
            raise ValueError(f"arrival tenant must be >= 0, got {self.tenant!r}")
        if not (self.priority > 0.0):
            raise ValueError(f"arrival priority must be > 0, got {self.priority!r}")


# ---------------------------------------------------------------------------
# the JSONL trace


def _parse_entry(obj, where: str) -> Arrival:
    if not isinstance(obj, dict):
        raise ValueError(f"{where}: expected a JSON object, got {type(obj).__name__}")
    unknown = set(obj) - {"t", "kind", "tenant", "priority"}
    if unknown:
        raise ValueError(f"{where}: unknown trace field(s) {sorted(unknown)}")
    try:
        t = obj["t"]
        kind = obj["kind"]
        tenant = obj["tenant"]
    except KeyError as e:
        raise ValueError(f"{where}: missing required field {e.args[0]!r}") from None
    if isinstance(t, bool) or not isinstance(t, (int, float)):
        raise ValueError(f"{where}: 't' must be a number, got {t!r}")
    if not isinstance(kind, str):
        raise ValueError(f"{where}: 'kind' must be a string, got {kind!r}")
    if isinstance(tenant, bool) or not isinstance(tenant, int):
        raise ValueError(f"{where}: 'tenant' must be an integer, got {tenant!r}")
    priority = obj.get("priority")
    if priority is not None and (isinstance(priority, bool)
                                 or not isinstance(priority, (int, float))):
        raise ValueError(f"{where}: 'priority' must be a number, got {priority!r}")
    try:
        return Arrival(float(t), kind, tenant, 1.0 if priority is None else float(priority))
    except ValueError as e:
        raise ValueError(f"{where}: {e}") from None


def load_trace(path: str) -> List[Arrival]:
    """Parse a JSONL arrival trace, sorted by (time, tenant). Raises
    ``ValueError`` with the file and line number of the first malformed
    line."""
    arrivals: List[Arrival] = []
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            where = f"{path}:{lineno}"
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{where}: invalid JSON ({e.msg})") from None
            arrivals.append(_parse_entry(obj, where))
    arrivals.sort(key=lambda a: (a.t, a.tenant))
    return arrivals


def save_trace(arrivals: Iterable[Union[Arrival, Sequence]], path: str) -> None:
    """Write arrivals (:class:`Arrival` or ``(t, kind, tenant[, priority])``)
    as a JSONL trace, the inverse of :func:`load_trace`. The default
    priority is left out on disk."""
    with open(path, "w", encoding="utf-8") as fh:
        for a in arrivals:
            if not isinstance(a, Arrival):
                a = Arrival(*a)
            obj = {"t": a.t, "kind": a.kind, "tenant": a.tenant}
            if a.priority != 1.0:
                obj["priority"] = a.priority
            fh.write(json.dumps(obj) + "\n")


# ---------------------------------------------------------------------------
# the seeded generators


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng((int(seed) & 0xFFFFFFFF, stream))


def poisson_arrival_times(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """``n`` arrival times of a Poisson process at ``rate`` arrivals a
    simulated second (exponential gaps)."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if not (rate > 0.0):
        raise ValueError(f"rate must be > 0, got {rate!r}")
    gaps = _rng(seed, _POISSON_STREAM).exponential(1.0 / rate, size=n)
    return np.cumsum(gaps)


def bursty_arrival_times(n: int, rate: float, seed: int = 0, burst: int = 8,
                         duty: float = 0.25) -> np.ndarray:
    """``n`` arrival times of an on/off process: geometric bursts of mean
    size ``burst`` at the on rate ``rate / duty``, with quiet gaps sized so
    the long-run rate is ``rate``."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if not (rate > 0.0):
        raise ValueError(f"rate must be > 0, got {rate!r}")
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    if not (0.0 < duty <= 1.0):
        raise ValueError(f"duty must be in (0, 1], got {duty!r}")
    rng = _rng(seed, _BURSTY_STREAM)
    on_rate = rate / duty
    # a cycle holds `burst` arrivals on average: burst/on_rate + off_gap
    off_gap = burst * (1.0 / rate - 1.0 / on_rate)
    times: List[float] = []
    t = 0.0
    while len(times) < n:
        size = 1 + rng.geometric(1.0 / burst)
        gaps = rng.exponential(1.0 / on_rate, size=size)
        for g in gaps:
            t += float(g)
            times.append(t)
            if len(times) == n:
                break
        t += float(rng.exponential(off_gap))
    return np.asarray(times, dtype=np.float64)


def diurnal_arrival_times(n: int, rate: float, seed: int = 0, period: float = 1.0,
                          depth: float = 0.9) -> np.ndarray:
    """``n`` arrival times at the rate ``rate * (1 + depth * sin(2 pi t /
    period))``, sampled by thinning against the peak rate."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if not (rate > 0.0):
        raise ValueError(f"rate must be > 0, got {rate!r}")
    if not (period > 0.0):
        raise ValueError(f"period must be > 0, got {period!r}")
    if not (0.0 <= depth < 1.0):
        raise ValueError(f"depth must be in [0, 1), got {depth!r}")
    rng = _rng(seed, _DIURNAL_STREAM)
    peak = rate * (1.0 + depth)
    times: List[float] = []
    t = 0.0
    while len(times) < n:
        t += float(rng.exponential(1.0 / peak))
        lam = rate * (1.0 + depth * math.sin(2.0 * math.pi * t / period))
        if rng.random() * peak <= lam:
            times.append(t)
    return np.asarray(times, dtype=np.float64)


def make_arrivals(process: str, n: int, rate: float = 50.0, seed: int = 0,
                  kinds: Optional[Sequence[str]] = None, priorities: Sequence[float] = (1.0,),
                  **kwargs) -> List[Arrival]:
    """``n`` tenant arrivals of the named process. Kinds and priorities
    come from a stream of their own, so one seed gives the same tenant mix
    under every process."""
    if process == "poisson":
        times = poisson_arrival_times(n, rate, seed, **kwargs)
    elif process == "bursty":
        times = bursty_arrival_times(n, rate, seed, **kwargs)
    elif process == "diurnal":
        times = diurnal_arrival_times(n, rate, seed, **kwargs)
    else:
        raise ValueError(f"arrival process must be one of {ARRIVAL_PROCESSES}, got {process!r}")
    if kinds is None:
        kinds = tuple(sorted(default_catalog()))
    rng = _rng(seed, _KIND_STREAM)
    kind_ix = rng.integers(len(kinds), size=n)
    prio_ix = rng.integers(len(priorities), size=n)
    return [
        Arrival(float(times[i]), kinds[int(kind_ix[i])], i, float(priorities[int(prio_ix[i])]))
        for i in range(n)
    ]


# ---------------------------------------------------------------------------
# the catalog and the serving driver


def default_catalog() -> Dict[str, Callable[[], object]]:
    """The graph catalog tenants draw from: small tile DAGs (5–30 tasks)
    at tile 256."""
    from ..linalg.cholesky import cholesky_graph
    from ..linalg.lu import lu_graph
    from ..linalg.qr import qr_graph

    return {
        "chol2": lambda: cholesky_graph(2, 256, with_fns=False),
        "chol4": lambda: cholesky_graph(4, 256, with_fns=False),
        "lu3": lambda: lu_graph(3, 256, with_fns=False),
        "qr3": lambda: qr_graph(3, 256, with_fns=False),
    }


def run_serving(
    arrivals: Sequence[Arrival],
    machine=None,
    strategy: Union[str, object] = "heft",
    *,
    seed: int = 0,
    noise: float = 0.0,
    rescore: str = "incremental",
    admission: str = "none",
    mem_capacity: int = 0,
    catalog: Optional[Dict[str, Callable[[], object]]] = None,
    audit: bool = False,
    max_events: Optional[int] = None,
    baselines: Optional[Dict[str, float]] = None,
    device="cuda",
    min_wide: int = 1,
) -> Dict[str, object]:
    """Drive one serving run: submit every arrival, run, report.

    Arrivals are submitted in ``(t, tenant)`` order, so a permuted list
    gives the same run. ``strategy`` (a spec, built on ``device``, or a
    policy) and the engine's pool score on ``device`` (default the card;
    raises without one unless ``device="cpu"``), as do the per-kind
    empty-machine baselines (the slowdown denominators, HEFT unless the
    spec names another strategy; ``baselines`` memoizes them across calls).
    Returns the reference's keys: ``engine``, ``results``, ``tenants``,
    ``report``, ``n_events``, ``n_arrivals``, ``n_admitted``,
    ``n_rejected``, ``n_deferred`` and ``rows_built``.
    """
    from ..configs.paper_machine import paper_machine
    from ..sched import resolve_on
    from .engine import Engine
    from .metrics import serving_report

    if machine is None:
        machine = paper_machine(4)
    catalog = default_catalog() if catalog is None else catalog
    spec = strategy if isinstance(strategy, str) else None
    strat = resolve_on(strategy, device) if spec is not None else strategy
    engine = Engine(machine, strat, seed=seed, noise=noise, rescore=rescore, admission=admission,
                    mem_capacity=mem_capacity, audit=audit, device=device, min_wide=min_wide)
    ordered = sorted(arrivals, key=lambda a: (a.t, a.tenant))
    ctxs = []
    for a in ordered:
        builder = catalog.get(a.kind)
        if builder is None:
            raise ValueError(f"arrival kind {a.kind!r} not in catalog (known: {sorted(catalog)})")
        ctxs.append((a, engine.submit(builder(), at=a.t, priority=a.priority)))
    results = engine.run(max_events=max_events)

    # the empty-machine baseline of each kind (not for a capped run: no
    # tenant result is reported from it)
    if baselines is None:
        baselines = {}
    if max_events is None:
        for a, _ctx in ctxs:
            if a.kind not in baselines:
                base = Engine(machine, resolve_on(spec or "heft", device), seed=seed, noise=0.0)
                base.submit(catalog[a.kind]())
                baselines[a.kind] = base.run()[0].makespan

    tenants: List[Dict[str, float]] = []
    for a, ctx in ctxs:
        if max_events is not None:
            break
        if ctx.rejected or ctx.n_done != ctx.n_tasks:
            continue
        makespan = ctx.finish - ctx.submit_at
        base = baselines[a.kind]
        first_start = min(iv.start for iv in ctx.intervals)
        tenants.append({
            "tenant": a.tenant,
            "kind": a.kind,
            "priority": a.priority,
            "submit_at": ctx.submit_at,
            "admit_at": ctx.admit_at,
            "makespan": makespan,
            "slowdown": makespan / base if base > 0 else float("inf"),
            "queue_delay": first_start - ctx.submit_at,
        })
    m = engine.metrics
    return {
        "engine": engine,
        "results": results,
        "tenants": tenants,
        "report": serving_report(tenants),
        "n_events": m.n_events,
        "n_arrivals": m.n_arrivals,
        "n_admitted": m.n_admitted,
        "n_rejected": m.n_rejected,
        "n_deferred": m.n_deferred,
        "rows_built": engine._serving.rows_built if engine._serving is not None else None,
    }
