"""Seeded surrogate-episode cases shared by the CPU tests
(test_torch_episode.py), the card tests (test_torch_cuda.py) and
``chip_smoke.py``'s episode phase: graph descriptions, machines and the
port's episode batches. Imports only numpy, torch and the port."""
from functools import partial

import numpy as np

from repro_torch.configs.paper_machine import paper_machine
from repro_torch.convert import graph_from_spec
from repro_torch.core import cached_graph
from repro_torch.core import episode as ep
from repro_torch.linalg.cholesky import cholesky_graph
from repro_torch.linalg.lu import lu_graph
from repro_torch.linalg.qr import qr_graph

# the figure sweeps' five strategies (benchmarks/common.py:107-113)
FIGURE_SPECS = ("heft", "ws", "dada?alpha=0", "dada?alpha=0.5", "dada?alpha=0.5&use_cp=1")
NOISE = 0.03
GRAPHS = {"cholesky": cholesky_graph, "lu": lu_graph, "qr": qr_graph}
MIB = 1 << 20
# a chain of ten 1 MiB writes on the one GPU, then a 9 MiB write: under a
# 10 MiB cap the eleventh placement needs nine victims, so all eight LRU
# rounds evict (and write back) and the memory stays over its cap
EVICT_CAP = 10 * MIB


def tile_graph(kind: str, nt: int, tile: int = 256):
    """The port's tile DAG, memoized as ``run_batch`` memoizes factories."""
    return cached_graph(partial(GRAPHS[kind], nt, tile, with_fns=False))


def evict_spec():
    """The graph description of the eight-round eviction chain (a size-0
    token orders the tasks and is never a victim)."""
    tasks = [
        {"kind": "gemm", "flops": 2e9, "accesses": [("token", 0, "rw"), (f"d{i}", MIB, "w")]}
        for i in range(10)
    ]
    tasks.append({"kind": "gemm", "flops": 2e9,
                  "accesses": [("token", 0, "rw"), ("big", 9 * MIB, "w")]})
    tasks.append({"kind": "gemm", "flops": 2e9,
                  "accesses": [("token", 0, "rw"), ("d0", MIB, "r"), ("d3", MIB, "r"),
                               ("out", MIB, "w")]})
    return tasks


def assorted_spec(seed: int = 0, n_tasks: int = 60, n_data: int = 14):
    """A seeded DAG of tasks with up to four accesses each on data of
    assorted sizes (no two equal), so every sum over reads and writes
    depends on its order."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1 << 16, 1 << 22, n_data)
    kinds = ("gemm", "trsm", "potrf", "syrk")
    tasks = []
    for _ in range(n_tasks):
        picks = rng.choice(n_data, size=int(rng.integers(1, 5)), replace=False)
        modes = rng.choice(["r", "w", "rw"], size=len(picks), p=[0.5, 0.2, 0.3])
        tasks.append({
            "kind": str(rng.choice(kinds)),
            "flops": float(rng.integers(1, 400)) * 1e7,
            "accesses": [(f"x{i}", int(sizes[i]), str(m)) for i, m in zip(picks, modes)],
        })
    return tasks


def wide_spec(seed: int = 0, n_free: int = 320, n_classes: int = 4, n_joins: int = 6,
              fan_in: int = 4):
    """A seeded DAG whose ready set is wide and whose every selection is a
    tie: ``n_free`` independent tasks in ``n_classes`` equal-cost classes
    (kind, flops and output size alike; each reads one shared input and
    writes its own output), then ``n_joins`` join tasks, each reading
    ``fan_in`` outputs of one class. Tasks of a class that feed no join
    share one priority, so the scan breaks each of their ties by index."""
    rng = np.random.default_rng(seed)
    kinds = ("gemm", "trsm", "potrf", "syrk")
    classes = [(kinds[c % len(kinds)], float(rng.integers(1, 50)) * 1e8,
                int(rng.integers(1, 8)) << 18) for c in range(n_classes)]
    tasks = []
    for i in range(n_free):
        kind, flops, size = classes[i % n_classes]
        tasks.append({"kind": kind, "flops": flops,
                      "accesses": [("src", MIB, "r"), (f"o{i}", size, "w")]})
    for j in range(n_joins):
        c = j % n_classes
        picks = rng.choice(np.arange(c, n_free, n_classes), size=fan_in, replace=False)
        kind, flops, size = classes[c]
        tasks.append({"kind": kind, "flops": flops,
                      "accesses": [(f"o{i}", size, "r") for i in sorted(picks)]
                      + [(f"join{j}", size, "w")]})
    return tasks


# the synthetic graphs' descriptions, by the name a case's graph key gives
SYNTHETIC = {"evict": evict_spec, "assorted": assorted_spec, "wide": wide_spec}


def synthetic_graph(name: str):
    return graph_from_spec(SYNTHETIC[name]())


def configs(graph, gpus, specs, seeds, caps=(0,), noise=NOISE):
    """``run_batch`` items over every (GPU count, spec, seed, capacity),
    in that order; one machine object per GPU count."""
    machines = {n: paper_machine(n) for n in gpus}
    return [
        {"graph": graph, "machine": machines[n], "strategy": s, "seed": sd,
         "noise": noise, "capacity": c}
        for n in gpus for s in specs for sd in seeds for c in caps
    ]


def plan_and_batch(items):
    """The plan (n_u from the largest memory id, as ``run_batch`` does) and
    the batch of one group of ``run_batch`` items."""
    max_mem = max(
        max((r.mem for r in c["machine"].resources if r.is_accelerator), default=-1)
        for c in items
    )
    plan = ep.build_plan(items[0]["graph"], items[0]["machine"], n_u=max_mem + 2)
    return plan, ep.config_batch(plan, items)


# (label, graph, GPU counts, specs, seeds, capacities in bytes, pad_to,
# extra_steps): the cases the CPU tests hold against the reference and the
# card tests and chip_smoke.py hold the kernel to its plain version on
SMALL_SPECS = ("heft", "ws", "dada?alpha=0", "dada?alpha=0.5&use_cp=1", "dada?alpha=1")
PARITY_SPECS = ("heft", "ws", "dada?alpha=0", "dada?alpha=0.5&use_cp=1")


def cases():
    out = [("small", ("cholesky", 4), (2,), SMALL_SPECS, (1, 2, 3, 4, 5), (0,), None, 0)]
    for kind in ("cholesky", "lu", "qr"):
        for gpus in (2, 8):
            out.append((f"{kind}8-g{gpus}", (kind, 8), (gpus,), PARITY_SPECS,
                        (1234, 1235, 1236), (0,), None, 0))
    out += [
        ("cap8MiB", ("cholesky", 8), (2,), ("dada?alpha=0.5", "heft"), (7,), (8 * MIB,), None, 0),
        ("cap-mixed", ("cholesky", 8), (8,), PARITY_SPECS, (7,), (0, 2 * MIB), None, 0),
        ("evict8", ("evict",), (1,), ("heft", "dada?alpha=0.5", "dada?alpha=0.5&use_cp=1"),
         (3,), (EVICT_CAP,), None, 0),
        ("assorted", ("assorted",), (1, 3, 8), SMALL_SPECS, (11,), (0, 3 * MIB), None, 0),
        ("wide", ("wide",), (2, 8), SMALL_SPECS, (5,), (0, 4 * MIB), None, 0),
        ("padded", ("cholesky", 4), (2, 5), FIGURE_SPECS, (9,), (0,), 24, 7),
    ]
    return out


def case_graph(graph_key):
    return synthetic_graph(graph_key[0]) if len(graph_key) == 1 else tile_graph(*graph_key)
