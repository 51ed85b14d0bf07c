"""Placement scoring on the device: the fused (ready × resources) matrices.

Counterpart of ``repro.core.backend.JaxScoringBackend.score_matrices``.
One call scores one activation. It gathers the ready tasks' read and
affinity-access CSR rows and their residency masks on the host, packs
them as they are (no padding) into one buffer of 8-byte slots
(:func:`repro_torch.kernels.sched_score.pack_activation`), and computes
in one call of :func:`repro_torch.kernels.sched_score.score_activation`:

  * ``per_read = where(size <= 0, 0, latency + size / bandwidth)``;
  * the transfer fold ``X_u`` over the unique memories;
  * the ``col_of`` gather to resources and the additive ``x_bias``;
  * the per-row maxima of ``X``;
  * the affinity fold ``S`` (resident-weighted bytes, or missing_bytes:
    minus the reads' sizes times their hops);
  * the cost ``C = base + X``, ``base`` the class duration per column.

On the card that is one host-to-device copy, one kernel launch, one
device-to-host copy and one synchronisation per activation. On the CPU
the same packed buffer goes through the kernel's plain version. Every
entry is bit-equal to ``repro``'s numpy path: the same IEEE operations in
the same order.

The strategies call :meth:`TorchScoringBackend.place_dada` and
:meth:`TorchScoringBackend.place_heft` instead (counterparts of the
reference's ``dada_lambda_search`` and ``heft_select``): the same
buffer carries a placement section after the scorer's (see
:mod:`repro_torch.kernels.sched_place`), the placement kernel runs right
after the scorer on the same stream and reads its output where it lies,
and only the placement comes back: one copy in, two launches, one copy
out, one synchronisation. With ``device="cpu"`` they score as
``score_matrices`` does and run the placement's plain versions over the
host values.

The serving pool (:mod:`repro_torch.runtime.rescore`) calls
:meth:`TorchScoringBackend.score_pool` once a round: the dirty rows of
every tenant graph, packed side by side (the CSR reads carry their own
residency masks, so rows of different graphs need nothing in common),
scored in one ``score_activation`` launch into the cost ``C = base + X``,
``base`` each task's static duration on the column's class.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.sched_place import (
    DadaPlacement,
    HeftPlacement,
    PlaceLayout,
    PlaceSpec,
    launch_placement,
    pack_dada,
    pack_heft,
    dada_place_plain,
    heft_select_plain,
    place_layout,
    place_spec,
    read_placement,
)
from ..kernels.sched_score import (
    launch_score,
    pack_activation,
    pack_machine,
    score_activation,
    score_layout,
    score_spec,
    unpack_outputs,
)
from .affinity import MISSING_BYTES, affinity_csr_source
from .machine import HOST_MEM

_MIN_SLOTS = 4096  # 32 KiB: the main path's widest activation fits
# from this many rows of one graph the reference's host transfer rows are
# summed by np.add.reduceat (repro/core/perfmodel.py:226)
NUMPY_ROWS = 32
# np.add.reduceat adds a segment's first element to the sum of the rest,
# which numpy folds in order below eight terms and pairwise from eight
_REDUCEAT_IN_ORDER = 8


def _reduceat_order(reads):
    """A task's reads in the order whose in-order fold from +0.0 forms
    ``np.add.reduceat``'s sum over them: the rest, then the first."""
    if len(reads) - 1 >= _REDUCEAT_IN_ORDER:
        raise NotImplementedError(
            f"a serving round of {NUMPY_ROWS} or more rows of one graph scores tasks of at "
            f"most {_REDUCEAT_IN_ORDER} reads; this task has {len(reads)}"
        )
    return reads[1:] + reads[:1]


def check_min_wide(min_wide) -> int:
    """Validate a strategy's ``min_wide`` (the narrowest activation that
    is scored on the device)."""
    if isinstance(min_wide, bool) or int(min_wide) != min_wide or min_wide < 1:
        raise ValueError(f"min_wide must be an integer >= 1, got {min_wide!r}")
    return int(min_wide)


def _grown(buf: Optional[torch.Tensor], k: int, **kwargs) -> torch.Tensor:
    """``buf`` if it holds ``k`` slots, else a new buffer of at least twice
    its size (and at least ``_MIN_SLOTS``)."""
    if buf is not None and buf.shape[0] >= k:
        return buf
    size = max(k, _MIN_SLOTS, 0 if buf is None else 2 * buf.shape[0])
    return torch.empty(size, **kwargs)


class TorchScoringBackend:
    """The scoring matrices and the placements of HEFT and DADA, computed
    on ``device``.

    Takes and returns host data (numpy arrays and lists). On the card the
    backend owns its staging buffers: a pinned host buffer and a device
    buffer each way, grown by doubling and never allocated per call.
    """

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self._machine_cache: Dict[tuple, tuple] = {}
        self._pool_cache: Dict[tuple, tuple] = {}  # score_pool's class columns
        self._host_in = self._host_out = self._dev_in = self._dev_out = None
        self._host_in_np = self._host_out_np = None  # numpy views, cheaper to slice

    def _machine(self, resources, transfer_model):
        """(n_u, the machine buffer on the device): the activation-invariant
        per-machine constants, cached per machine."""
        mems = tuple(r.mem for r in resources)
        accel = tuple(r.is_accelerator for r in resources)
        key = (mems, accel, transfer_model.latency, transfer_model.bandwidth)
        m = self._machine_cache.get(key)
        if m is None:
            uniq, col_of, _ = transfer_model.mem_plan(mems)
            buf = pack_machine(
                len(resources),
                latency=transfer_model.latency, bandwidth=transfer_model.bandwidth,
                # residency tests shift the full masks by mem+1
                mem_shift=[u + 1 for u in uniq],
                host_col=[mem == HOST_MEM for mem in uniq],
                col_of=col_of, accel_res=accel,
            )
            m = (len(uniq), torch.from_numpy(buf).to(self.device))
            self._machine_cache[key] = m
        return m

    def _staging(self, n_in: int, n_out: int) -> None:
        """Grow the owned buffers to hold ``n_in`` input and ``n_out``
        output slots (on the CPU only the input buffer, not pinned)."""
        on_card = self.device.type == "cuda"
        host_in = self._host_in
        self._host_in = _grown(host_in, n_in, dtype=torch.int64, pin_memory=on_card)
        if self._host_in is not host_in:
            self._host_in_np = self._host_in.numpy()
        if on_card:
            host_out = self._host_out
            self._dev_in = _grown(self._dev_in, n_in, dtype=torch.int64, device=self.device)
            self._host_out = _grown(host_out, n_out, dtype=torch.float64, pin_memory=True)
            self._dev_out = _grown(self._dev_out, n_out, dtype=torch.float64, device=self.device)
            if self._host_out is not host_out:
                self._host_out_np = self._host_out.numpy()

    def pack(
        self,
        sim,
        tids: Sequence[int],
        resources,
        *,
        p_cpu: Optional[Sequence[float]] = None,
        p_gpu: Optional[Sequence[float]] = None,
        use_cp: bool = False,
        affinity: Optional[str] = None,
        x_rows: bool = False,
        x_bias: Optional[np.ndarray] = None,
        place: Optional[PlaceSpec] = None,
    ):
        """Gather one activation's CSR rows on the host and pack them into
        the host staging buffer. Returns ``(layout, packed, machine)``: the
        activation's :class:`ScoreLayout`, a view of the staging buffer
        holding it (valid until the next call) and the machine buffer on
        the device. The arguments are :meth:`score_matrices`'s. With
        ``place``, the layout is that placement's :class:`PlaceLayout` and
        ``packed`` leaves its section, after the scorer's, to the caller."""
        n_u, machine = self._machine(resources, sim.transfer_model)
        arr = sim.arrays
        residency = sim.residency
        tids_arr = np.asarray(tids, dtype=np.int64)
        reads = writes = None
        if use_cp:
            r_indptr, r_ids, r_sizes = arr.gather_csr(
                tids_arr, arr.read_indptr, arr.read_ids, arr.read_sizes
            )
            reads = (r_indptr, residency.mask_of_ids(r_ids), r_sizes)
        accel_only = False
        if affinity is not None:
            w_indptr_full, w_ids_full, w_weights_full, accel_only = (
                affinity_csr_source(affinity, arr)
            )
            w_indptr, w_ids, w_weights = arr.gather_csr(
                tids_arr, w_indptr_full, w_ids_full, w_weights_full
            )
            writes = (w_indptr, residency.mask_of_ids(w_ids), w_weights)
        want_c = p_cpu is not None
        want_bias = use_cp and x_bias is not None
        layout = score_layout(score_spec(
            n=len(tids), nnz_r=len(reads[1]) if use_cp else 0,
            nnz_w=len(writes[1]) if writes is not None else 0,
            n_u=n_u, n_res=len(resources),
            want_x=use_cp, x_rows=use_cp and x_rows, want_bias=want_bias,
            want_s=writes is not None, accel_only=accel_only, want_c=want_c,
            s_missing=affinity == MISSING_BYTES,
        ))
        score = layout
        if place is not None:
            layout = place_layout(place, score.spec)
        self._staging(layout.n_in, score.n_out + (layout.n_out if place is not None else 0))
        packed = self._host_in[:layout.n_in]
        pack_activation(
            self._host_in_np[:score.n_in], score, reads=reads, writes=writes,
            p_cpu=p_cpu if want_c else None, p_gpu=p_gpu if want_c else None,
            x_bias=x_bias if want_bias else None,
        )
        return layout, packed, machine

    def score_matrices(self, sim, tids: Sequence[int], resources, **kwargs) -> dict:
        """Fused (ready × resources) scoring matrices.

        Keywords: ``p_cpu`` and ``p_gpu`` (per-class durations), ``use_cp``,
        ``affinity``, ``x_rows`` and ``x_bias``. Returns ``{"C": list
        rows|None, "C_np": array|None, "X_np": array|None, "X_rowmax":
        list|None, "S_np": array|None}``: cost ``C`` (class duration +
        predicted transfer) when per-class durations are given; transfer
        times ``X`` when ``use_cp`` (full rows with ``x_rows=True``, else
        only the per-row maxima); affinity ``S`` when ``affinity`` names a
        score (:data:`~repro_torch.core.affinity.AFFINITIES`). ``x_bias`` is an additive (n × resources)
        penalty folded into ``X`` before ``C`` and the row maxima derive
        from it.
        """
        layout, packed, machine = self.pack(sim, tids, resources, **kwargs)
        got = unpack_outputs(self._score(layout, packed, machine), layout)
        return dict(
            C=got["C"].tolist() if got["C"] is not None else None, C_np=got["C"],
            X_np=got["X"],
            X_rowmax=got["X_max"].tolist() if got["X_max"] is not None else None,
            S_np=got["S"],
        )

    def _score(self, layout, packed: torch.Tensor, machine: torch.Tensor) -> np.ndarray:
        """Score one packed buffer: on the card one copy in, one
        ``score_activation`` launch, one copy back and one synchronisation;
        on the CPU the plain version. Returns the output slots (f64)."""
        if self.device.type == "cuda":
            dev_in = self._dev_in[:layout.n_in]
            dev_out = self._dev_out[:layout.n_out]
            host_out = self._host_out[:layout.n_out]
            dev_in.copy_(packed, non_blocking=True)
            score_activation(dev_in, layout, machine, out=dev_out)
            host_out.copy_(dev_out, non_blocking=True)
            # the one synchronisation of the call: the results are on the
            # host, and both staging buffers are free for the next call
            torch.cuda.current_stream(self.device).synchronize()
            return host_out.numpy().copy()
        return score_activation(packed, layout, machine).numpy()

    def _pool_classes(self, resources):
        """(a CPU rid, a GPU rid): whose static durations are ``p_cpu`` and
        ``p_gpu`` of a pool's rows. The scorer's ``base`` takes one class
        for the accelerators and one for the rest, so a machine with more
        is refused."""
        key = tuple((r.is_accelerator, r.cls.name) for r in resources)
        got = self._pool_cache.get(key)
        if got is None:
            names = {}
            for r in resources:
                if names.setdefault(r.is_accelerator, r.cls.name) != r.cls.name:
                    raise ValueError(
                        "the serving pool scores one class of accelerators and one of other "
                        f"resources; this machine has {sorted({r.cls.name for r in resources})}"
                    )
            first = {}
            for j, r in enumerate(resources):
                first.setdefault(r.is_accelerator, j)
            cpu = first.get(False, first.get(True))
            got = self._pool_cache[key] = (cpu, first.get(True, cpu))
        return got

    def score_pool(self, groups, resources, transfer_model) -> np.ndarray:
        """The serving pool's rows of one round: ``groups`` is a list of
        ``(ctx, tids)``, each a tenant graph's context and its dirty tasks.
        Their read CSR rows (masks from each graph's own residency) and
        static durations are packed side by side into one buffer and
        scored in one ``score_activation`` launch. Returns the
        ``(rows × resources)`` cost ``C = base + X``, the rows in group
        order: ``base`` is each task's static duration on the column's
        class, ``X`` its predicted input-transfer time, so an entry equals
        ``x + static`` of the reference's host rows bit for bit. The
        reference sums a group of ``NUMPY_ROWS`` or more rows with
        ``np.add.reduceat``, first read plus the sum of the rest; such a
        group's reads go in rotated by one, so the kernel's in-order fold
        forms the same sums."""
        n_u, machine = self._machine(resources, transfer_model)
        cpu_j, gpu_j = self._pool_classes(resources)
        # a pool round holds a few rows of many graphs, each with a few
        # reads: gathered from the per-task read lists (in CSR order)
        indptr, masks, sizes, p_cpu, p_gpu = [0], [], [], [], []
        for ctx, tids in groups:
            task_reads = ctx.arrays.task_reads
            mask_list = ctx.residency.mask_list
            cpu_static, gpu_static = ctx.rid_static[cpu_j], ctx.rid_static[gpu_j]
            wide = len(tids) >= NUMPY_ROWS
            for t in tids:
                reads = task_reads[t]
                if wide and len(reads) > 2:
                    reads = _reduceat_order(reads)
                for did, _name, size in reads:
                    masks.append(mask_list[did])
                    sizes.append(size)
                indptr.append(len(masks))
                p_cpu.append(cpu_static[t])
                p_gpu.append(gpu_static[t])
        layout = score_layout(score_spec(
            n=len(p_cpu), nnz_r=len(masks), nnz_w=0, n_u=n_u, n_res=len(resources),
            want_x=True, want_c=True,
        ))
        self._staging(layout.n_in, layout.n_out)
        pack_activation(
            self._host_in_np[:layout.n_in], layout,
            reads=(np.asarray(indptr, dtype=np.int64), np.asarray(masks, dtype=np.int64),
                   np.asarray(sizes, dtype=np.float64)),
            p_cpu=p_cpu, p_gpu=p_gpu,
        )
        out = self._score(layout, self._host_in[:layout.n_in], machine)
        return unpack_outputs(out, layout)["C"]

    def _place(self, layout: PlaceLayout, packed: torch.Tensor, machine: torch.Tensor):
        """Score and place one packed activation on the card: one copy in,
        ``score_activation`` and the placement kernel on the same stream,
        one copy of the placement back, one synchronisation. The launches
        go through the kernels' pointer-level entries: these buffers are
        sized to the layout by ``pack``."""
        score = layout.score
        n_scores, n_placed = score.n_out, layout.n_out
        stream = torch.cuda.current_stream(self.device)
        index, handle = self.device.index or 0, stream.cuda_stream
        self._dev_in[:layout.n_in].copy_(packed, non_blocking=True)
        in_ptr, out_ptr = self._dev_in.data_ptr(), self._dev_out.data_ptr()
        launch_score(in_ptr, machine.data_ptr(), out_ptr, score, index, handle)
        launch_placement(in_ptr, out_ptr, out_ptr + 8 * n_scores, layout, index, handle)
        self._host_out[:n_placed].copy_(self._dev_out[n_scores:n_scores + n_placed],
                                        non_blocking=True)
        # the one synchronisation: the placement is on the host, and both
        # staging buffers are free for the next call
        stream.synchronize()
        return read_placement(self._host_out_np[:n_placed].view(np.int64), layout)

    def place_dada(self, sim, tids: Sequence[int], resources, *, p_cpu, p_gpu, use_cp: bool,
                   affinity: Optional[str], area_bound: bool, cpu_rids, gpu_rids,
                   x_bias: Optional[np.ndarray] = None, **section) -> DadaPlacement:
        """DADA's placement of one activation, scored and searched on the
        device (counterpart of ``dada_lambda_search`` and the ``try_build``
        after it): the cost matrix from ``p_cpu`` / ``p_gpu`` and, with
        ``use_cp``, the transfers plus ``x_bias`` (the memory-pressure
        penalty under a capacity); the affinity matrix of ``affinity``
        (None: no affinity phase); the rest of the section as
        :func:`~repro_torch.kernels.sched_place.pack_dada` takes it, with
        the liveness inputs (``pen``, ``skip``, ``n_alive``, ``pen_top``)
        when a resource is detached or noticed: then the layout is live.
        Dead or alive, an activation is one copy in, two launches, one copy
        out and one synchronisation. With ``device="cpu"``: the scorer's
        plain version, then the search's, over the host values (no section
        to pack)."""
        if self.device.type == "cpu":
            m = self.score_matrices(sim, tids, resources, p_cpu=p_cpu, p_gpu=p_gpu,
                                    use_cp=use_cp, affinity=affinity, x_bias=x_bias)
            return dada_place_plain(C=m["C"], S=m["S_np"], x_max=m["X_rowmax"], p_cpu=p_cpu,
                                    p_gpu=p_gpu, tids=tids, area_bound=area_bound,
                                    cpu_rids=cpu_rids, gpu_rids=gpu_rids, **section)
        spec = place_spec("dada", len(tids), len(resources), len(cpu_rids), len(gpu_rids), 0,
                          area_bound, "pen" in section)
        layout, packed, machine = self.pack(sim, tids, resources, p_cpu=p_cpu, p_gpu=p_gpu,
                                            use_cp=use_cp, affinity=affinity, x_bias=x_bias,
                                            place=spec)
        pack_dada(self._host_in_np[:layout.n_in], layout, tids=tids, cpu_rids=cpu_rids,
                  gpu_rids=gpu_rids, **section)
        return self._place(layout, packed, machine)

    def place_heft(self, sim, tids: Sequence[int], resources, *, order, durations, cls_of_res,
                   load_ts, now: float, x_bias: Optional[np.ndarray] = None) -> HeftPlacement:
        """HEFT's placement of one activation, scored and scanned on the
        device (counterpart of ``heft_select``): the transfer rows of the
        ready tasks plus ``x_bias`` (the memory-pressure penalty under a
        capacity), then the EFT scan in priority ``order`` over the class
        ``durations`` (``cls_of_res``: each resource's class), from
        ``load_ts`` at ``now``. With ``device="cpu"``: the scorer's plain
        version, then the scan's, over the host values."""
        scan = dict(order=order, durations=durations, cls_of_res=cls_of_res, load_ts=load_ts,
                    now=now)
        if self.device.type == "cpu":
            X = self.score_matrices(sim, tids, resources, use_cp=True, x_rows=True,
                                    x_bias=x_bias)["X_np"]
            return heft_select_plain(X=X.tolist(), **scan)
        spec = place_spec("heft", len(tids), len(resources), 0, 0, len(durations), False)
        layout, packed, machine = self.pack(sim, tids, resources, use_cp=True, x_rows=True,
                                            x_bias=x_bias, place=spec)
        pack_heft(self._host_in_np[:layout.n_in], layout, **scan)
        return self._place(layout, packed, machine)
