"""Shared harness of the paper-figure sweeps: the counterpart of the
reference's ``benchmarks/common.py``.

Methodology mirrors the paper (§4.1): each configuration is run repeatedly
with different seeds, and a row reports the mean and 95% CI of GFLOPS and
of the transferred GB. Matrix 8192x8192, tile 512 (16x16 tiles), inner
block 128, fp64 item size: the paper's problem shape.

Every setting is an argument: runs, GPU counts, the engine (``exact``:
:func:`run_many` over the event-driven engine; ``surrogate``: one
:func:`run_batch` per figure) and the device. Sweeps return their rows and
write nothing to disk.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, Sequence, Tuple

from ..configs.paper_machine import paper_machine
from ..core import Summary, cached_graph, run_batch, run_many
from ..core.api import ci95
from ..device import resolve_device
from ..linalg.cholesky import cholesky_graph
from ..linalg.lu import lu_graph
from ..linalg.qr import qr_graph
from ..sched import resolve_on

MATRIX = 8192
TILE = 512
NT = MATRIX // TILE
# the paper's depth, and the reference's fast one (REPRO_BENCH_FAST)
PAPER_RUNS, PAPER_GPUS = 30, (1, 2, 3, 4, 5, 6, 7, 8)
FAST_RUNS, FAST_GPUS = 3, (2, 4, 8)
ENGINES = ("exact", "surrogate")


def graphs_for(nt: int = NT, tile: int = TILE) -> Dict[str, Callable]:
    """Paper-kernel graph factories at tile-grid size ``nt``."""
    return {
        "cholesky": partial(cholesky_graph, nt, tile, with_fns=False),
        "lu": partial(lu_graph, nt, tile, with_fns=False),
        "qr": partial(qr_graph, nt, tile, with_fns=False),
    }


# the five rows of fig2-fig4: label -> registry spec
STRATEGIES: Dict[str, str] = {
    "heft": "heft",
    "ws": "ws",
    "dada(0)": "dada?alpha=0",
    "dada(a)": "dada?alpha=0.5",
    "dada(a)+cp": "dada?alpha=0.5&use_cp=1",
}


strategy_for = resolve_on  # ``spec`` built for ``device`` (ws and random take none)


Config = Tuple[int, str, str]  # (n_gpus, label, spec)


def _summaries_exact(configs: Sequence[Config], graph_factory, n_runs: int, device,
                     audit: bool = False) -> List[Summary]:
    return [
        run_many(graph_factory, paper_machine(n_gpus), partial(strategy_for, spec, device),
                 n_runs=n_runs, audit=audit)
        for n_gpus, _, spec in configs
    ]


def _summaries_batched(configs: Sequence[Config], graph_factory, n_runs: int,
                       device) -> List[Summary]:
    """Surrogate path: every (strategy × GPU-count × seed) cell is one
    configuration of a single ``run_batch`` call."""
    graph = cached_graph(graph_factory)
    machines = {}
    items = []
    for n_gpus, _, spec in configs:
        m = machines.setdefault(n_gpus, paper_machine(n_gpus))
        for i in range(n_runs):
            items.append({"graph": graph, "machine": m, "strategy": spec,
                          "seed": 1234 + i, "noise": 0.03})
    results = run_batch(items, device=device)
    summaries = []
    for k, (_, label, _) in enumerate(configs):
        rs = results[k * n_runs:(k + 1) * n_runs]
        gf = [r.gflops for r in rs]
        gb = [r.gbytes for r in rs]
        summaries.append(Summary(
            strategy=label, n=n_runs,
            gflops_mean=float(sum(gf) / len(gf)), gflops_ci95=ci95(gf),
            gbytes_mean=float(sum(gb) / len(gb)), gbytes_ci95=ci95(gb),
            makespan_mean=float(sum(r.makespan for r in rs) / len(rs)),
            steals_mean=0.0,
        ))
    return summaries


def sweep_summaries(
    kernel: str,
    strategies: Dict[str, str],
    n_runs: int,
    gpu_counts: Sequence[int],
    engine: str = "exact",
    device="cuda",
    nt: int = NT,
    tile: int = TILE,
    audit: bool = False,
) -> List[Tuple[int, str, Summary]]:
    """(n_gpus, label, Summary) of every strategy × GPU count, GPU count
    major, unrounded. ``audit``: every exact run is audited and verified
    (an error raises); the surrogate refuses it, its logs come from
    ``episode_audit_logs``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (use one of {ENGINES})")
    if audit and engine != "exact":
        raise ValueError("audit= audits the exact engine's runs; the surrogate's logs come "
                         "from episode_audit_logs")
    dev = resolve_device(device)
    configs = [(n_gpus, label, spec) for n_gpus in gpu_counts for label, spec in strategies.items()]
    if not configs:
        return []
    graph_factory = graphs_for(nt, tile)[kernel]
    if engine == "exact":
        summaries = _summaries_exact(configs, graph_factory, n_runs, dev, audit)
    else:
        summaries = _summaries_batched(configs, graph_factory, n_runs, dev)
    return [(n_gpus, label, s) for (n_gpus, label, _), s in zip(configs, summaries)]


def row_of(fig: str, kernel: str, label: str, n_gpus: int, s: Summary) -> dict:
    """One figure row, rounded as the reference's CSV rows are."""
    return dict(
        fig=fig,
        kernel=kernel,
        strategy=label,
        n_gpus=n_gpus,
        n_runs=s.n,
        gflops=round(s.gflops_mean, 2),
        gflops_ci95=round(s.gflops_ci95, 2),
        gbytes=round(s.gbytes_mean, 4),
        gbytes_ci95=round(s.gbytes_ci95, 4),
        makespan_s=round(s.makespan_mean, 5),
        steals=round(s.steals_mean, 1),
    )


def sweep(
    fig: str,
    kernel: str,
    strategies: Dict[str, str],
    n_runs: int,
    gpu_counts: Sequence[int],
    engine: str = "exact",
    device="cuda",
    nt: int = NT,
    tile: int = TILE,
    audit: bool = False,
) -> List[dict]:
    """Run strategies × GPU counts on ``engine``; return the row dicts."""
    return [
        row_of(fig, kernel, label, n_gpus, s)
        for n_gpus, label, s in sweep_summaries(
            kernel, strategies, n_runs, gpu_counts, engine=engine, device=device, nt=nt, tile=tile,
            audit=audit)
    ]


def format_row(row: dict) -> str:
    """A row on one line, every value as the row holds it."""
    return (
        f"  {row['fig']} {row['kernel']} gpus={row['n_gpus']} {row['strategy']:12s} "
        f"{row['gflops']} GF (±{row['gflops_ci95']}) {row['gbytes']} GB "
        f"(±{row['gbytes_ci95']}) makespan {row['makespan_s']} s steals={row['steals']}"
    )
