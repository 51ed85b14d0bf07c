"""Performance models: history-based task timing + bandwidth transfer model.

Paper §2.3: "Our task prediction relies on an history-based model, and
transfer time estimation is based on asymptotic bandwidth". The runtime
observes durations (the simulator's ground-truth rates with seeded noise)
and corrects its predictions online.

Counterpart of ``repro.core.perfmodel``. ``Residency`` stores one bitmask
per data object (bit ``mem+1`` set ⇔ a valid copy lives in memory space
``mem``; the host, ``HOST_MEM = -1``, is bit 0), so residency tests are
O(1) bit tests. The transfer rows here are the host path, taken for
activations narrower than a strategy's ``min_wide``; wider ones are
scored by :class:`repro_torch.core.backend.TorchScoringBackend`, which
folds the same masks on the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .dag import GraphArrays, Task
from .machine import HOST_MEM, ResourceClass

# Residency masks live in int64 arrays: bit 0 is the host, bit (mem+1) is
# device memory ``mem``; 62 device memories fit before the sign bit.
_MAX_MEM = 61


def _mem_bit(mem: int) -> int:
    if not -1 <= mem <= _MAX_MEM:
        raise ValueError(f"memory id {mem} outside supported range [-1, {_MAX_MEM}]")
    return 1 << (mem + 1)


@dataclass
class HistoryPerfModel:
    """Per (task kind, resource class) running mean of observed durations.

    Before any observation the prediction is the static estimate
    ``flops / class_rate``. ``version`` increments on every ``observe`` so
    :class:`ClassPredictor` knows when its per-kind cache is stale.
    """

    _stats: Dict[Tuple[str, str], Tuple[int, float]] = field(default_factory=dict)
    version: int = 0

    def observe(self, task: Task, cls: ResourceClass, duration: float) -> None:
        key = (task.kind, cls.name)
        n, mean = self._stats.get(key, (0, 0.0))
        n += 1
        mean += (duration - mean) / n
        self._stats[key] = (n, mean)
        self.version += 1

    def kind_table(
        self, cls: ResourceClass, kinds: Sequence[str]
    ) -> Tuple[List[float], List[bool]]:
        """(means, observed) per kind for resource class ``cls``."""
        means = []
        observed = []
        stats = self._stats
        name = cls.name
        for kind in kinds:
            st = stats.get((kind, name))
            if st is not None and st[0] > 0:
                means.append(st[1])
                observed.append(True)
            else:
                means.append(0.0)
                observed.append(False)
        return means, observed


class ClassPredictor:
    """Cached vectorized duration prediction for one resource class.

    The static fallback ``flops / rate`` (with a 1e-7 floor for tasks
    without flops) is a per-task constant, computed once per graph; the
    per-kind observed means are rebuilt whenever the model's version
    moves. ``times(tids)`` returns the observed running mean where one
    exists and the static estimate otherwise.
    """

    def __init__(self, model: HistoryPerfModel, cls: ResourceClass, arr: GraphArrays):
        self.model = model
        self.cls = cls
        self.arr = arr
        rates = np.array([cls.rate(k) for k in arr.kinds], dtype=np.float64)
        static = arr.flops / rates[arr.kind_codes]
        self.static_times = np.where(arr.flops <= 0.0, 1e-7, static)
        self.static_list = self.static_times.tolist()
        self._codes_list = arr.kind_codes.tolist()
        self._version = -1
        self._means_list: List[float] = []
        self._observed_list: List[bool] = []

    def _refresh(self) -> None:
        if self._version != self.model.version:
            self._means_list, self._observed_list = self.model.kind_table(
                self.cls, self.arr.kinds
            )
            self._version = self.model.version

    def times(self, tids: np.ndarray) -> np.ndarray:
        """Predicted durations for tasks ``tids``."""
        self._refresh()
        codes = self.arr.kind_codes[tids]
        means = np.asarray(self._means_list, dtype=np.float64)
        observed = np.asarray(self._observed_list, dtype=bool)
        return np.where(
            observed[codes], means[codes], self.static_times[tids]
        )

    def times_list(self, tids: Sequence[int]) -> List[float]:
        """Scalar form of :meth:`times` for narrow activations."""
        self._refresh()
        codes = self._codes_list
        means = self._means_list
        observed = self._observed_list
        static = self.static_list
        out = []
        for tid in tids:
            c = codes[tid]
            out.append(means[c] if observed[c] else static[tid])
        return out


def class_duration_matrix(sim, tids: Sequence[int]) -> np.ndarray:
    """(ready × resources) predicted durations from ``sim``'s per-class
    predictors (one lookup per class)."""
    cols = {}
    out = np.empty((len(tids), len(sim.machine.resources)), dtype=np.float64)
    for j, r in enumerate(sim.machine.resources):
        col = cols.get(r.cls.name)
        if col is None:
            col = cols[r.cls.name] = sim.predictor(r.cls).times_list(list(tids))
        out[:, j] = col
    return out


@dataclass
class TransferModel:
    """Asymptotic-bandwidth estimator for host<->device transfers.

    A *prediction*: it ignores the switch contention that the engine's
    ground truth models, as in the paper.
    """

    bandwidth: float
    latency: float = 1e-5

    def __post_init__(self) -> None:
        # memoized unique-memory decompositions, keyed by the mems tuple
        self._mem_plans: Dict[tuple, tuple] = {}

    def mem_plan(self, mems: tuple) -> tuple:
        """Decompose a resource→memory list into (unique mems, column-of,
        already-unique flag). Memoized; shared by the host rows and the
        device backend so both see the identical column layout."""
        cached = self._mem_plans.get(mems)
        if cached is None:
            uniq: List[int] = []
            col_of: List[int] = []
            seen: Dict[int, int] = {}
            for mem in mems:
                j = seen.get(mem)
                if j is None:
                    j = seen[mem] = len(uniq)
                    uniq.append(mem)
                col_of.append(j)
            cached = (uniq, col_of, len(uniq) == len(mems))
            self._mem_plans[mems] = cached
        return cached

    def task_input_transfer_rows(
        self,
        arr: GraphArrays,
        tids: Sequence[int],
        mems: Sequence[int],
        residency: "Residency",
    ) -> List[List[float]]:
        """(len(tids) × len(mems)) predicted input-transfer times, as rows.

        Narrow activations take a scalar path over the per-task read lists
        and the residency bitmasks, wide ones the batched numpy path. Both
        compute ``hops * (latency + size/bandwidth)`` summed in access
        order, so every entry is the same IEEE value.
        """
        # resources sharing a memory space (all CPUs see host memory) share
        # a column: compute per unique memory, then expand
        uniq, col_of, full = self.mem_plan(tuple(mems))

        n = len(tids)
        if n >= 32:
            arr_tids = np.asarray(tids, dtype=np.int64)
            rows = self.task_input_transfer_matrix(
                arr, arr_tids, uniq, residency
            ).tolist()
        else:
            masks = residency._mask
            # per-task (read name, per-hop time) pairs are graph-static
            key = ("read_times", self.latency, self.bandwidth)
            prep = arr.cache.get(key)
            if prep is None:
                latency = self.latency
                bandwidth = self.bandwidth
                prep = [
                    [
                        (name, 0.0 if size <= 0 else latency + size / bandwidth)
                        for _, name, size in reads
                    ]
                    for reads in arr.task_reads
                ]
                arr.cache[key] = prep
            rows = []
            for tid in tids:
                reads = [(masks.get(name, 0), t) for name, t in prep[tid]]
                row = []
                for mem in uniq:
                    bit = 1 << (mem + 1)
                    total = 0.0
                    for m, t in reads:
                        if m & bit or m == 0:
                            continue
                        if mem == HOST_MEM or m & 1:
                            total += t
                        else:
                            total += 2 * t
                    row.append(total)
                rows.append(row)
        if full:
            return rows
        return [[row[j] for j in col_of] for row in rows]

    def task_input_transfer_matrix(
        self,
        arr: GraphArrays,
        tids: np.ndarray,
        mems: Sequence[int],
        residency: "Residency",
    ) -> np.ndarray:
        """(len(tids) × len(mems)) predicted input-transfer times from the
        read-CSR slice and the residency bitmasks, summed in access order."""
        indptr, ids, sizes = arr.gather_csr(
            tids, arr.read_indptr, arr.read_ids, arr.read_sizes
        )
        n, m = len(tids), len(mems)
        if len(ids) == 0:
            return np.zeros((n, m), dtype=np.float64)
        masks = residency.mask_of_ids(ids)
        per_read = np.where(sizes <= 0, 0.0, self.latency + sizes / self.bandwidth)
        on_host = (masks & 1) != 0
        nowhere = masks == 0
        out = np.empty((n, m), dtype=np.float64)
        # reduceat quirks: an empty segment yields the element at its start
        # (fixed up below), and a start index == len(contrib) is invalid
        # (avoided by the appended 0.0, which also absorbs harmlessly into
        # the sum of the final non-empty segment).
        empty_seg = indptr[:-1] == indptr[1:]
        fix_empty = bool(empty_seg.any())
        for j, mem in enumerate(mems):
            bit = _mem_bit(mem)
            resident = (masks & bit) != 0
            if mem == HOST_MEM:
                hops = np.where(resident | nowhere, 0.0, 1.0)
            else:
                hops = np.where(
                    resident | nowhere, 0.0, np.where(on_host, 1.0, 2.0)
                )
            contrib = hops * per_read
            col = np.add.reduceat(np.append(contrib, 0.0), indptr[:-1])[:n]
            if fix_empty:
                col = np.where(empty_seg, 0.0, col)
            out[:, j] = col
        return out


class Residency:
    """Tracks which memory spaces hold a *valid* copy of each data object.

    Writes invalidate all other copies (MSI-like). Storage is one int
    bitmask per data object in a name-keyed dict; :meth:`attach` binds
    the tracker to a :class:`GraphArrays` id space and mirrors the masks
    into ``mask_list`` (indexed by data id) for the array paths.

    ``observer``, when set, is called as ``observer(did, name, old, new)``
    on every attached-mode mask change: the capacity-bounded memory layer
    (:mod:`repro_torch.runtime.memory`) installs it to mirror residency
    into its per-memory accounting. With no observer (the default) the
    hot paths pay one ``is not None`` check.
    """

    def __init__(self) -> None:
        self._mask: Dict[str, int] = {}
        self._name_to_id: Optional[Dict[str, int]] = None
        self.mask_list: Optional[List[int]] = None
        self._sizes: Optional[List[int]] = None
        self.observer = None

    def attach(self, arr: GraphArrays) -> None:
        """Bind to a graph's data-id space (enables the array paths)."""
        self._name_to_id = arr.name_to_id
        self.mask_list = [0] * len(arr.data_names)
        self._sizes = arr.data_sizes.tolist()
        for name, did in arr.name_to_id.items():
            self.mask_list[did] = self._mask.get(name, 0)

    def _set_mask(self, name: str, new: int) -> None:
        old = self._mask.get(name, 0)
        self._mask[name] = new
        if self._name_to_id is not None:
            did = self._name_to_id.get(name)
            if did is not None:
                self.mask_list[did] = new
                if self.observer is not None and old != new:
                    self.observer(did, name, old, new)

    def mask_of_ids(self, ids: np.ndarray) -> np.ndarray:
        """Bitmask vector for data ids (attached mode only)."""
        ml = self.mask_list
        return np.fromiter(map(ml.__getitem__, ids), dtype=np.int64, count=len(ids))

    def add_copy(self, name: str, mem: int) -> None:
        self._set_mask(name, self._mask.get(name, 0) | _mem_bit(mem))

    def drop_copy(self, name: str, mem: int) -> None:
        """Invalidate the copy of ``name`` at ``mem`` (eviction), leaving
        any other valid copy; a no-op when no copy is there."""
        self._set_mask(name, self._mask.get(name, 0) & ~_mem_bit(mem))

    def has_any(self, name: str) -> bool:
        return self._mask.get(name, 0) != 0

    def locations(self, name: str) -> set:
        """The memories holding a valid copy of ``name`` (host: -1)."""
        mask, mem, out = self._mask.get(name, 0), -1, set()
        while mask:
            if mask & 1:
                out.add(mem)
            mask >>= 1
            mem += 1
        return out

    def transfer_hops(self, name: str, dst_mem: int) -> int:
        """Hops to bring ``name`` to ``dst_mem``: 0 if a valid copy is there
        or no copy exists yet; 1 if ``dst_mem`` is the host or a host copy
        exists; 2 device to device (device -> host -> device, the
        paper-era PCIe path)."""
        m = self._mask.get(name, 0)
        if m == 0 or m & _mem_bit(dst_mem):
            return 0
        if dst_mem == HOST_MEM or m & 1:
            return 1
        return 2

    def write(self, name: str, mem: int) -> None:
        self._set_mask(name, _mem_bit(mem))

    def write_id(self, did: int, name: str, new_mask: int) -> None:
        """Attached-mode fast write: caller supplies the data id and the
        (validated) single-bit mask. Semantically ``write(name, mem)``."""
        ml = self.mask_list
        observer = self.observer
        if observer is not None:
            old = ml[did]
            self._mask[name] = ml[did] = new_mask
            if old != new_mask:
                observer(did, name, old, new_mask)
            return
        self._mask[name] = new_mask
        ml[did] = new_mask

    def initialize(self, names: Iterable[str], mem: int) -> None:
        for n in names:
            self.write(n, mem)
