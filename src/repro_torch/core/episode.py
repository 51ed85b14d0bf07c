"""Batched surrogate episodes: whole list-scheduling runs in one launch.

Counterpart of ``repro.core.episode``. The exact engine
(:mod:`repro_torch.runtime.engine`) is the oracle; this module is the
approximation a sweep runs when it wants many configurations fast: a
*whole* greedy list-scheduling placement episode (ready-set maintenance
over the padded CSR incidence, per-resource score rows, argmin
assignment, EFT/clock advance, residency bitmask updates and, with a
capacity, a bounded LRU eviction pass) as one scan over task steps with
fixed-shape padded state, batched over a leading axis of configurations
(seeds × α/cp parameters × machine shapes × capacities).

On the card the whole scan of every configuration is one launch of the
hand-written kernel ``episode_scan`` (:mod:`repro_torch.kernels.sched_episode`,
one warp per configuration, every step on the warp). Which task a step
selects depends only on the plan, so the plan carries the selection
order (``EpisodePlan.order``) and the kernel reads it. On the CPU
the plain version runs the same steps as a Python loop over PyTorch ops
with the batch axis written out. Both compute in f32 with the reference's
contractions (see that module), so each step's task and resource choice
and every f32 value equal the reference's compiled scan.

What the surrogate relaxes against the exact engine (and why rankings
still transfer) is the reference's to state: tie-breaking by index
order, a static upward-rank list priority, static ``flops/rate``
estimates with the seeded noise applied to the executed durations,
transfers paid serially and FIFO on the destination's link group, and at
most eight LRU victims per placement. Correctness is ranking
fidelity against the oracle, plus equality with the reference's episode.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.sched_episode import (
    _NEVER,
    SCHEDULE_COLUMNS,
    PlanTables,
    _tables_from,
    episode_scan,
    selection_order,
)
from ..verify.audit import AuditLog, graph_accesses
from .dag import TaskGraph
from .machine import HOST_MEM, MachineModel


def _bucket(n: int, lo: int = 8) -> int:
    """Next power-of-two ≥ n (≥ lo): the padding of the read, write and
    successor widths."""
    b = lo
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# host-side plan: one graph × one machine template, shared by a whole batch


@dataclass
class EpisodePlan:
    """Padded arrays for one (graph, machine-template) pair.

    Shared across every configuration in a batch: configurations vary the
    resource composition (``is_gpu``/``mem_col``), the strategy parameters
    and the seeds — not the incidence structure.
    """

    n: int
    n_pad: int
    r_pad: int
    w_pad: int
    s_pad: int
    n_data: int
    n_u: int
    n_res: int
    read_ids: np.ndarray  # (n_pad, r_pad) int32, padded entries -> n_data + j
    read_t: np.ndarray  # (n_pad, r_pad) f64 per-read one-hop seconds
    read_sz: np.ndarray  # (n_pad, r_pad) f64 bytes
    write_ids: np.ndarray  # (n_pad, w_pad) int32, padded entries -> n_data + j
    write_sz: np.ndarray  # (n_pad, w_pad) f64 bytes
    succ_ids: np.ndarray  # (n_pad, s_pad) int32, padded entries -> n_pad + j
    indeg0: np.ndarray  # (n_pad + 1,) int32 (+1: dummy scatter slot)
    prio: np.ndarray  # (n_pad,) f64 upward rank (higher = earlier)
    dur_cpu: np.ndarray  # (n_pad,) f64 static exec times (1e-7 floor)
    dur_gpu: np.ndarray
    sizes: np.ndarray  # (n_data + 1,) f64 bytes (dummy slot last)
    col_bits: np.ndarray  # (n_u,) int32: bit 0 host, bit 1+g device g
    host_col: np.ndarray  # (n_u,) bool
    bandwidth: float
    latency: float
    total_flops: float
    # (≤ n,) int32: the tasks in the order the scan selects them, from the
    # f32 priorities the scan compares (selection_order); the same for every
    # configuration of a batch
    order: np.ndarray
    # device -> (the plan's 13 input tensors there, their PlanTables), built
    # once by _on_device
    on_device: Dict[torch.device, tuple] = field(default_factory=dict, repr=False,
                                                 compare=False)


def _pad2(rows: List[List[Tuple[int, float]]], n_pad: int, width: int, fill_id: int):
    # pad slot j carries the *distinct* dummy id fill_id + j: indices stay
    # unique within a row, and every scatter drops the out-of-range ones
    ids = np.tile(fill_id + np.arange(width, dtype=np.int32), (n_pad, 1))
    val = np.zeros((n_pad, width), dtype=np.float64)
    for t, row in enumerate(rows):
        for j, (i, v) in enumerate(row):
            ids[t, j] = i
            val[t, j] = v
    return ids, val


def build_plan(
    graph: TaskGraph, machine: MachineModel, n_u: Optional[int] = None
) -> EpisodePlan:
    """Build (and memoize on ``arrays().cache``) the padded episode plan.

    ``machine`` is a *template*: it supplies the CPU/GPU resource classes
    and the link model. ``n_u`` is the unique-memory column count the
    batch needs (1 + the largest device-memory id across the batch);
    defaults to this machine's own layout.
    """
    arr = graph.arrays()
    cpu_cls = next((r.cls for r in machine.resources if not r.is_accelerator), None)
    gpu_cls = next((r.cls for r in machine.resources if r.is_accelerator), None)
    if cpu_cls is None:
        cpu_cls = gpu_cls
    if gpu_cls is None:
        gpu_cls = cpu_cls
    max_mem = max((r.mem for r in machine.resources if r.is_accelerator), default=-1)
    if n_u is None:
        n_u = max_mem + 2
    key = (
        "episode_plan", n_u, len(machine.resources),
        cpu_cls.name, gpu_cls.name,
        machine.link.bandwidth, machine.link.latency,
    )
    plan = arr.cache.get(key)
    if plan is not None:
        return plan

    n = arr.n_tasks
    # multiples of 128 (not pow2): the scan walks (B, n_pad) state every
    # step, so a 1496-task trace padded to 2048 would pay 37% dead traffic
    n_pad = max(128, -(-n // 128) * 128)
    n_data = len(arr.data_sizes)
    lat, bw = machine.link.latency, machine.link.bandwidth

    reads = [
        [(did, 0.0 if sz <= 0 else lat + sz / bw) for did, _, sz in row]
        for row in arr.task_reads
    ]
    r_pad = _bucket(max((len(r) for r in reads), default=1), lo=2)
    read_ids, read_t = _pad2(reads, n_pad, r_pad, n_data)
    _, read_sz = _pad2(
        [[(did, float(sz)) for did, _, sz in row] for row in arr.task_reads],
        n_pad, r_pad, n_data,
    )
    writes = [[(did, float(sz)) for did, _, sz in row] for row in arr.task_writes]
    w_pad = _bucket(max((len(w) for w in writes), default=1), lo=2)
    write_ids, write_sz = _pad2(writes, n_pad, w_pad, n_data)

    succ = [graph.succ[t.tid] for t in graph.tasks]
    s_pad = _bucket(max((len(s) for s in succ), default=1), lo=2)
    succ_ids = np.tile(n_pad + np.arange(s_pad, dtype=np.int32), (n_pad, 1))
    for t, ss in enumerate(succ):
        succ_ids[t, : len(ss)] = ss

    indeg0 = np.full(n_pad + 1, _NEVER, dtype=np.int32)
    indeg0[:n] = [len(graph.pred[t.tid]) for t in graph.tasks]

    # static exec-time vectors, identical to ClassPredictor's bootstrap
    def _static(cls) -> np.ndarray:
        rates = np.array([cls.rate(k) for k in arr.kinds], dtype=np.float64)
        est = arr.flops / rates[arr.kind_codes]
        est = np.where(arr.flops <= 0.0, 1e-7, est)
        out = np.zeros(n_pad, dtype=np.float64)
        out[:n] = est
        return out

    dur_cpu = _static(cpu_cls)
    dur_gpu = _static(gpu_cls)

    # upward rank over machine-average durations + produced-data transfer
    # time: a static critical-path-aware list priority
    avg = (dur_cpu[:n] + dur_gpu[:n]) / 2.0
    comm = np.array(
        [
            max((lat + sz / bw for _, _, sz in row if sz > 0), default=0.0)
            for row in arr.task_writes
        ]
    )
    prio = np.zeros(n_pad, dtype=np.float64)
    for tid in reversed(graph.topo_order()):
        down = max((prio[s] for s in graph.succ[tid]), default=0.0)
        prio[tid] = avg[tid] + comm[tid] + down

    sizes = np.zeros(n_data + 1, dtype=np.float64)
    sizes[:n_data] = arr.data_sizes

    col_bits = np.array([1 << u for u in range(n_u)], dtype=np.int32)
    host_col = np.zeros(n_u, dtype=bool)
    host_col[0] = True

    plan = EpisodePlan(
        n=n, n_pad=n_pad, r_pad=r_pad, w_pad=w_pad, s_pad=s_pad,
        n_data=n_data, n_u=n_u, n_res=len(machine.resources),
        read_ids=read_ids, read_t=read_t, read_sz=read_sz,
        write_ids=write_ids, write_sz=write_sz, succ_ids=succ_ids,
        indeg0=indeg0, prio=prio, dur_cpu=dur_cpu, dur_gpu=dur_gpu,
        sizes=sizes, col_bits=col_bits, host_col=host_col,
        bandwidth=bw, latency=lat, total_flops=graph.total_flops(),
        order=selection_order(indeg0, prio.astype(np.float32), succ_ids),
    )
    arr.cache[key] = plan
    return plan


# ---------------------------------------------------------------------------
# per-configuration batch axes


@dataclass
class EpisodeBatch:
    """Stacked per-configuration inputs (leading axis = batch)."""

    is_gpu: np.ndarray  # (B, R) bool
    valid_res: np.ndarray  # (B, R) bool
    mem_col: np.ndarray  # (B, R) int32 unique-memory column per resource
    link_grp: np.ndarray  # (B, R) int32 link group per resource (< R)
    alpha: np.ndarray  # (B,) f64 affinity weight
    use_cp: np.ndarray  # (B,) f64 0/1: transfer prediction in the score
    ws_pref: np.ndarray  # (B,) bool: parent-worker (LIFO) preference
    noise: np.ndarray  # (B, n_pad) f64 multiplicative duration factors
    cap: np.ndarray  # (B,) f64 device-memory bytes (+inf = unbounded)

    def __len__(self) -> int:
        return len(self.alpha)


def surrogate_params(spec: str) -> Tuple[float, float, bool]:
    """Map a policy spec to surrogate (alpha, use_cp, ws_pref) axes.

    Only list-scheduling strategies have a surrogate form: ``heft`` is
    EFT with transfer prediction, ``dada``/``dual`` add the α-weighted
    write-affinity bonus, ``ws`` is blind EFT with a parent-worker (LIFO
    locality) preference. Randomized policies have no mapping — the
    exact engine remains their only path.
    """
    from ..sched.registry import parse_spec

    name, raw = parse_spec(spec)
    truthy = ("1", "true", "yes", "on")
    if name == "heft":
        return 0.0, 1.0, False
    if name == "ws":
        return 0.0, 0.0, True
    if name in ("dada", "dual"):
        alpha = 0.0 if name == "dual" else 0.5
        if "alpha" in raw:
            alpha = float(raw["alpha"])
        use_cp = 1.0 if str(raw.get("use_cp", "0")).lower() in truthy else 0.0
        return alpha, use_cp, False
    raise ValueError(
        f"strategy {spec!r} has no surrogate episode mapping "
        "(supported: heft, ws, dada, dual); run it on the exact engine"
    )


def noise_factors(seed: int, noise: float, n: int, n_pad: int) -> np.ndarray:
    """The oracle's per-task duration factors, from the identical stream
    (``Engine.submit`` draws one batched normal in tid order)."""
    out = np.ones(n_pad, dtype=np.float64)
    if noise > 0 and n > 0:
        out[:n] = np.exp(np.random.default_rng(seed).normal(0.0, noise, size=n))
    return out


def machine_axes(
    machine: MachineModel, n_res: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(is_gpu, valid, mem_col, link_grp) rows for one machine, padded to
    ``n_res``.

    ``link_grp`` densely renumbers the machine's PCIe switch groups and
    gives every CPU its own group — transfers into a resource serialize
    FIFO against others on the same group (the oracle's ``link_free``),
    and host-side pulls don't contend with each other. Group ids stay
    below the resource count, so the episode's link clock is (B, R).
    """
    is_gpu = np.zeros(n_res, dtype=bool)
    valid = np.zeros(n_res, dtype=bool)
    mem_col = np.zeros(n_res, dtype=np.int32)
    link_grp = np.zeros(n_res, dtype=np.int32)
    groups: Dict[int, int] = {}
    for r in machine.resources:
        if r.is_accelerator and r.link is not None:
            groups.setdefault(r.link, len(groups))
    n_sw = len(groups)
    for r in machine.resources:
        is_gpu[r.rid] = r.is_accelerator
        valid[r.rid] = True
        mem_col[r.rid] = 0 if r.mem == HOST_MEM else r.mem + 1
        if r.is_accelerator and r.link is not None:
            link_grp[r.rid] = groups[r.link]
        else:
            n_sw += 1
            link_grp[r.rid] = min(n_sw - 1, n_res - 1)
    return is_gpu, valid, mem_col, link_grp


def config_batch(plan: EpisodePlan, configs: Sequence[Mapping]) -> EpisodeBatch:
    """The batch axes of ``configs`` (mappings as :func:`repro_torch.core.run_batch`
    takes them: ``machine``, ``strategy``, ``seed``, ``noise``, ``capacity``;
    a capacity of 0 or none is unbounded) over ``plan``."""
    axes: Dict[int, tuple] = {}
    rows = []
    for c in configs:
        m = c["machine"]
        if id(m) not in axes:
            axes[id(m)] = machine_axes(m, plan.n_res)
        capacity = float(c.get("capacity", 0) or 0)
        rows.append((
            axes[id(m)], surrogate_params(c["strategy"]),
            noise_factors(int(c.get("seed", 0)), float(c.get("noise", 0.03)), plan.n, plan.n_pad),
            capacity if capacity > 0 else np.inf,
        ))
    return EpisodeBatch(
        is_gpu=np.stack([r[0][0] for r in rows]),
        valid_res=np.stack([r[0][1] for r in rows]),
        mem_col=np.stack([r[0][2] for r in rows]),
        link_grp=np.stack([r[0][3] for r in rows]),
        alpha=np.array([r[1][0] for r in rows]),
        use_cp=np.array([r[1][1] for r in rows]),
        ws_pref=np.array([r[1][2] for r in rows], dtype=bool),
        noise=np.stack([r[2] for r in rows]),
        cap=np.array([r[3] for r in rows]),
    )


# ---------------------------------------------------------------------------
# the episode: one launch on the card, the plain scan on the CPU


def _tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def _on_device(plan: EpisodePlan, device) -> tuple:
    """The plan's 13 input tensors on ``device`` and their tables, made
    once and memoized with the plan: every group of the plan shares them,
    and the tables (order, task records) are bound to these tensors."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    got = plan.on_device.get(device)
    if got is None:
        f32, i32 = np.float32, np.int32
        rows = (
            _tensor(plan.read_ids, device, i32), _tensor(plan.read_t, device, f32),
            _tensor(plan.read_sz, device, f32), _tensor(plan.write_ids, device, i32),
            _tensor(plan.write_sz, device, f32), _tensor(plan.succ_ids, device, i32),
            _tensor(plan.indeg0, device, i32), _tensor(plan.prio, device, f32),
            _tensor(plan.dur_cpu, device, f32), _tensor(plan.dur_gpu, device, f32),
            _tensor(plan.sizes, device, f32), _tensor(plan.col_bits, device, i32),
            _tensor(plan.host_col, device, bool),
        )
        # plan.order is the selection order of plan.prio in f32, which
        # rows[7] holds
        got = plan.on_device[device] = (rows, _tables_from(rows, plan.order))
    return got


def episode_tables(plan: EpisodePlan, device) -> PlanTables:
    """The plan's :class:`PlanTables` on ``device``: the selection order and
    the task records, bound to the plan tensors that :func:`episode_inputs`
    hands out there (built once per plan and device)."""
    return _on_device(plan, device)[1]


def episode_inputs(
    plan: EpisodePlan, batch: EpisodeBatch, device, pad_to: Optional[int] = None
) -> Tuple[torch.Tensor, ...]:
    """The episode's 23 arguments on ``device``, in the reference's order
    (plan arrays, then batch axes padded to ``pad_to`` rows when it is
    given, then the bandwidth), every float in f32: the surrogate runs in
    f32. The plan's 13 tensors are made once per device and shared by
    every call (:func:`episode_tables` is bound to them); do not change
    them in place."""
    B = len(batch)
    B_pad = B if pad_to is None else pad_to
    if B_pad < B:
        raise ValueError(f"pad_to={B_pad} smaller than batch ({B})")

    def padb(a: np.ndarray, fill=0) -> np.ndarray:
        if B_pad == B:
            return a
        pad = np.full((B_pad - B,) + a.shape[1:], fill, dtype=a.dtype)
        return np.concatenate([a, pad], axis=0)

    def t(a, dtype=None) -> torch.Tensor:
        return _tensor(a, device, dtype)

    f32, i32 = np.float32, np.int32
    return (
        *_on_device(plan, device)[0],
        # padded batch rows: no valid resource, so every score is inf and
        # each step places its task on resource 0; they share nothing with
        # the real rows and are dropped from the results
        t(padb(batch.is_gpu), bool), t(padb(batch.valid_res), bool),
        t(padb(batch.mem_col), i32), t(padb(batch.link_grp), i32),
        t(padb(batch.alpha), f32), t(padb(batch.use_cp), f32),
        t(padb(batch.ws_pref), bool), t(padb(batch.noise, fill=1), f32),
        t(padb(batch.cap, fill=np.inf), f32),
        torch.tensor(plan.bandwidth, dtype=torch.float32, device=device),
    )


def run_episodes(
    plan: EpisodePlan,
    batch: EpisodeBatch,
    *,
    device="cuda",
    extra_steps: int = 0,
    pad_to: Optional[int] = None,
    emit_schedule: bool = False,
) -> Dict[str, np.ndarray]:
    """Run every configuration of ``batch`` through one episode scan: one
    ``episode_scan`` launch on the card, the plain scan on the CPU.

    Returns ``makespan`` / ``total_bytes`` / ``n_placed`` arrays aligned
    with the batch. The batch runs unpadded: one warp (or one plain row) a
    configuration, the kernel reading the plan's tables (selection order
    and task records, :func:`episode_tables`). ``extra_steps`` and
    ``pad_to`` (batch-axis padding) exist for the padding-invariance
    tests: extra steps find no ready task and change nothing; padded rows
    run a scan of their own (every task on resource 0) that never touches
    the real rows, and are dropped.

    ``emit_schedule`` additionally returns a ``"schedule"`` dict of
    (B, n_steps) arrays — per-step chosen task/resource and timeline
    (``tid``, ``rid``, ``act``, ``start``, ``xfer_t``, ``fin``,
    ``xfer_b``, ``evict_b``), as the reference emits them.
    """
    dev = resolve_device(device)
    B = len(batch)
    args = episode_inputs(plan, batch, dev, pad_to)
    use_cap = bool(np.isfinite(batch.cap).any())
    res = episode_scan(
        *args, n_steps=plan.n + int(extra_steps), use_cap=use_cap, emit=bool(emit_schedule),
        tables=episode_tables(plan, dev),
    )
    mk, total_b, n_placed = (r.cpu().numpy() for r in res[:3])
    out = {
        "makespan": mk[:B].astype(np.float64),
        "total_bytes": total_b[:B].astype(np.float64),
        "n_placed": n_placed[:B],
    }
    if emit_schedule:
        out["schedule"] = {
            name: col.cpu().numpy()[:B] for name, col in zip(SCHEDULE_COLUMNS, res[3])
        }
    return out


def episode_audit_logs(graph: TaskGraph, batch: EpisodeBatch, out: Mapping) -> List[AuditLog]:
    """Convert a ``run_episodes(..., emit_schedule=True)`` output (from the
    card or the CPU) into one audit log per configuration.

    Each batch row becomes one :class:`repro_torch.verify.AuditLog` with
    ``engine="surrogate"``: per-step placements as exec records (start
    after the step's transfer time, end at the step's finish), demand
    transfers and capacity write-backs as hop records, and the episode's
    claimed makespan / total bytes as the result footer — the schema the
    exact engine emits, so :func:`repro_torch.verify.verify_audit`
    re-checks surrogate schedules with no engine-specific code. The logs
    equal ``repro.core.episode.episode_audit_logs``'s on the same batch.
    """
    sched = out["schedule"]
    accesses = graph_accesses(graph)
    n = len(accesses)
    n_res = batch.mem_col.shape[1]
    logs = []
    for b in range(len(batch)):
        log = AuditLog(engine="surrogate")
        log.machine = {
            "host_mem": 0,
            "resources": [
                {
                    "rid": r,
                    "mem": int(batch.mem_col[b, r]),
                    "valid": bool(batch.valid_res[b, r]),
                    "link": int(batch.link_grp[b, r]),
                }
                for r in range(n_res)
            ],
        }
        log.graphs[0] = {"submit_at": 0.0, "tasks": accesses}
        for k in range(sched["tid"].shape[1]):
            if not sched["act"][b, k]:
                continue
            tid = int(sched["tid"][b, k])
            if tid >= n:
                continue  # padded step ids never activate; defensive
            rid = int(sched["rid"][b, k])
            start = float(sched["start"][b, k])
            xt = float(sched["xfer_t"][b, k])
            xb = float(sched["xfer_b"][b, k])
            eb = float(sched["evict_b"][b, k])
            fin = float(sched["fin"][b, k])
            log.log_exec(0, tid, rid, int(batch.mem_col[b, rid]), start + xt, fin)
            grp = int(batch.link_grp[b, rid])
            if xb > 0:
                log.log_hop("copy", int(round(xb)), grp, start, start + xt)
            if eb > 0:
                log.log_hop("writeback", int(round(eb)), grp, start, fin)
        log.result = {
            "total_bytes": float(out["total_bytes"][b]),
            "n_transfers": None,
            "makespan": float(out["makespan"][b]),
            "per_graph": {
                0: {"finish": float(out["makespan"][b]), "submit_at": 0.0}
            },
        }
        logs.append(log)
    return logs
