"""Data-flow task graph, XKaapi-style.

Tasks declare typed accesses (READ / WRITE / RW) on named data objects.
Dependencies are derived from access modes in *program order*, exactly as a
data-flow runtime does it:

  RAW: a reader depends on the last writer of the data.
  WAW: a writer depends on the last writer.
  WAR: a writer depends on every reader since the last writer.

Counterpart of ``repro.core.dag``. A task may carry an executable body
(``fn``, run by :mod:`repro_torch.linalg.execute`); the scheduler, the
structure-of-arrays view and the fingerprints never read it.
"""
from __future__ import annotations

import enum
import heapq
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class Mode(enum.Enum):
    R = "r"
    W = "w"
    RW = "rw"

    @property
    def reads(self) -> bool:
        return self in (Mode.R, Mode.RW)

    @property
    def writes(self) -> bool:
        return self in (Mode.W, Mode.RW)


@dataclass(frozen=True)
class DataObject:
    """A named, sized piece of data (e.g. a matrix tile)."""

    name: str
    size_bytes: int
    # Free-form payload handle (e.g. tile coordinates).
    meta: Any = None

    def __repr__(self) -> str:  # keep logs short
        return f"Data({self.name},{self.size_bytes}B)"


@dataclass(frozen=True)
class Access:
    data: DataObject
    mode: Mode


@dataclass
class Task:
    """A unit of work with data accesses and per-kind cost metadata."""

    tid: int
    kind: str
    accesses: Tuple[Access, ...]
    flops: float = 0.0
    # Optional: callable run by the executor; signature
    # fn(*input_tensors) -> tuple of output tensors matching write accesses.
    fn: Optional[Callable] = None
    tag: Any = None

    def __repr__(self) -> str:
        return f"Task({self.tid}:{self.kind})"


class GraphArrays:
    """Structure-of-arrays view of a :class:`TaskGraph`.

    Built once per graph: int-coded task kinds, a flops vector, and CSR
    read/write/access incidence over int-coded data objects. Sizes are
    stored *per access* (``read_sizes`` aligns with ``read_ids``) so a
    graph that rebinds a name to a differently sized object keeps the
    exact per-access semantics.
    """

    __slots__ = (
        "n_tasks", "kinds", "kind_codes", "flops",
        "data_names", "name_to_id", "data_sizes",
        "read_indptr", "read_ids", "read_sizes",
        "write_indptr", "write_ids", "write_sizes",
        "acc_indptr", "acc_ids", "acc_sizes", "acc_writes", "acc_first",
        "task_reads", "task_writes", "cache",
    )

    def __init__(self, graph: "TaskGraph") -> None:
        tasks = graph.tasks
        n = len(tasks)
        self.n_tasks = n
        kind_index: Dict[str, int] = {}
        kind_codes = np.empty(n, dtype=np.int32)
        flops = np.empty(n, dtype=np.float64)
        self.name_to_id: Dict[str, int] = {}
        self.data_names: List[str] = []
        sizes: List[int] = []

        r_indptr = np.empty(n + 1, dtype=np.int64)
        w_indptr = np.empty(n + 1, dtype=np.int64)
        a_indptr = np.empty(n + 1, dtype=np.int64)
        r_ids: List[int] = []
        r_sizes: List[int] = []
        w_ids: List[int] = []
        w_sizes: List[int] = []
        a_ids: List[int] = []
        a_sizes: List[int] = []
        a_writes: List[bool] = []
        a_first: List[bool] = []
        # per-task (data_id, name, size_bytes) triples for scalar hot loops
        self.task_reads: List[List[Tuple[int, str, int]]] = []
        self.task_writes: List[List[Tuple[int, str, int]]] = []

        r_indptr[0] = w_indptr[0] = a_indptr[0] = 0
        for t in tasks:
            kind_codes[t.tid] = kind_index.setdefault(t.kind, len(kind_index))
            flops[t.tid] = t.flops
            tr: List[Tuple[int, str, int]] = []
            tw: List[Tuple[int, str, int]] = []
            seen: set = set()
            for a in t.accesses:
                name = a.data.name
                did = self.name_to_id.get(name)
                if did is None:
                    did = len(self.data_names)
                    self.name_to_id[name] = did
                    self.data_names.append(name)
                    sizes.append(a.data.size_bytes)
                else:
                    sizes[did] = a.data.size_bytes  # last access wins
                a_ids.append(did)
                a_sizes.append(a.data.size_bytes)
                a_writes.append(a.mode.writes)
                a_first.append(name not in seen)
                seen.add(name)
                if a.mode.reads:
                    r_ids.append(did)
                    r_sizes.append(a.data.size_bytes)
                    tr.append((did, name, a.data.size_bytes))
                if a.mode.writes:
                    w_ids.append(did)
                    w_sizes.append(a.data.size_bytes)
                    tw.append((did, name, a.data.size_bytes))
            r_indptr[t.tid + 1] = len(r_ids)
            w_indptr[t.tid + 1] = len(w_ids)
            a_indptr[t.tid + 1] = len(a_ids)
            self.task_reads.append(tr)
            self.task_writes.append(tw)

        self.kinds: List[str] = [k for k, _ in sorted(kind_index.items(), key=lambda kv: kv[1])]
        self.kind_codes = kind_codes
        self.flops = flops
        self.data_sizes = np.asarray(sizes, dtype=np.int64)
        self.read_indptr = r_indptr
        self.read_ids = np.asarray(r_ids, dtype=np.int64)
        self.read_sizes = np.asarray(r_sizes, dtype=np.float64)
        self.write_indptr = w_indptr
        self.write_ids = np.asarray(w_ids, dtype=np.int64)
        self.write_sizes = np.asarray(w_sizes, dtype=np.float64)
        self.acc_indptr = a_indptr
        self.acc_ids = np.asarray(a_ids, dtype=np.int64)
        self.acc_sizes = np.asarray(a_sizes, dtype=np.float64)
        self.acc_writes = np.asarray(a_writes, dtype=bool)
        self.acc_first = np.asarray(a_first, dtype=bool)
        # scratch space for consumers that cache derived arrays, keyed by
        # their own tags
        self.cache: Dict[Any, Any] = {}

    # ------------------------------------------------------------------
    def gather_csr(
        self, tids: np.ndarray, indptr: np.ndarray, *arrays: np.ndarray
    ) -> Tuple[np.ndarray, ...]:
        """Gather CSR rows ``tids``: returns (row_indptr, gathered arrays...).

        ``row_indptr`` has ``len(tids)+1`` entries delimiting each task's
        slice in the concatenated output, preserving per-access order.
        """
        starts = indptr[tids]
        ends = indptr[tids + 1]
        counts = ends - starts
        out_indptr = np.empty(len(tids) + 1, dtype=np.int64)
        out_indptr[0] = 0
        np.cumsum(counts, out=out_indptr[1:])
        total = int(out_indptr[-1])
        if total == 0:
            return (out_indptr,) + tuple(
                np.empty(0, dtype=a.dtype) for a in arrays
            )
        # flat index vector: for each row, starts[i] + [0..counts[i])
        flat = np.repeat(starts - out_indptr[:-1], counts) + np.arange(total)
        return (out_indptr,) + tuple(a[flat] for a in arrays)


class TaskGraph:
    """A DAG built by appending tasks in program order (data-flow semantics)."""

    def __init__(self) -> None:
        self.tasks: List[Task] = []
        self.succ: Dict[int, List[int]] = {}
        self.pred: Dict[int, List[int]] = {}
        # data-flow bookkeeping (program-order construction state)
        self._last_writer: Dict[str, int] = {}
        self._readers_since_write: Dict[str, List[int]] = {}
        self._arrays: Optional[GraphArrays] = None

    # ------------------------------------------------------------------
    def add_task(
        self,
        kind: str,
        accesses: Sequence[Tuple[DataObject, Mode]],
        flops: float = 0.0,
        fn: Optional[Callable] = None,
        tag: Any = None,
    ) -> Task:
        tid = len(self.tasks)
        task = Task(
            tid=tid,
            kind=kind,
            accesses=tuple(Access(d, m) for d, m in accesses),
            flops=flops,
            fn=fn,
            tag=tag,
        )
        self.tasks.append(task)
        self.succ[tid] = []
        self.pred[tid] = []
        self._arrays = None  # invalidate the structure-of-arrays view

        deps: set = set()
        for acc in task.accesses:
            key = acc.data.name
            if acc.mode.reads:
                lw = self._last_writer.get(key)
                if lw is not None:
                    deps.add(lw)  # RAW
            if acc.mode.writes:
                lw = self._last_writer.get(key)
                if lw is not None:
                    deps.add(lw)  # WAW
                for r in self._readers_since_write.get(key, ()):  # WAR
                    deps.add(r)
        deps.discard(tid)
        for d in sorted(deps):
            self.succ[d].append(tid)
            self.pred[tid].append(d)

        # update construction state *after* dep computation
        for acc in task.accesses:
            key = acc.data.name
            if acc.mode.writes:
                self._last_writer[key] = tid
                self._readers_since_write[key] = []
            if acc.mode.reads and not acc.mode.writes:
                self._readers_since_write.setdefault(key, []).append(tid)
        return task

    # ------------------------------------------------------------------
    def arrays(self) -> GraphArrays:
        """Structure-of-arrays view (built once, invalidated by add_task)."""
        if self._arrays is None:
            self._arrays = GraphArrays(self)
        return self._arrays

    def __len__(self) -> int:
        return len(self.tasks)

    def roots(self) -> List[Task]:
        return [t for t in self.tasks if not self.pred[t.tid]]

    def total_flops(self) -> float:
        return sum(t.flops for t in self.tasks)

    def topo_order(self) -> List[int]:
        """Kahn topological order (deterministic: ready set kept sorted)."""
        indeg = {t.tid: len(self.pred[t.tid]) for t in self.tasks}
        ready = sorted(tid for tid, d in indeg.items() if d == 0)
        order: List[int] = []
        heapq.heapify(ready)
        while ready:
            tid = heapq.heappop(ready)
            order.append(tid)
            for s in self.succ[tid]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(ready, s)
        if len(order) != len(self.tasks):
            raise ValueError("cycle detected in task graph")
        return order
