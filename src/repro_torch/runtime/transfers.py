"""Transfer layer: link groups, the in-flight index, prefetch routing.

  * transfers serialize FIFO on their *link group* (GPUs sharing a PCIe
    switch share its bandwidth — ``link_free`` tracks when each group
    drains);
  * the in-flight index is kept per graph context and per data name
    (``ctx.inflight[name] -> {dst_mem: done_t}``), so duplicate requests
    dedup in O(1) and a write invalidates stale entries in O(copies);
  * GPU→GPU moves route through the host (two hops, the paper-era PCIe
    path), reusing an already-in-flight host hop when one exists.

A transfer in flight when its data is overwritten still lands as a valid
copy: ``repro``'s engine keeps that modeling artifact by default, and
this engine matches it bit for bit.

Capacity-bounded memories (:mod:`repro_torch.runtime.memory`, wired by
the engine as ``memory``) hook in at request time: space at the
destination is reserved before the hop is scheduled, so any eviction
write-back the reservation triggers queues ahead of the incoming copy on
the same link. Unbounded runs never reach the hook.

With an audit log attached (``audit``, wired by the engine), every hop is
logged with its kind (``copy``, or ``writeback`` for a dirty eviction)
and every request notes its time, so the landing record can carry it.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..core.machine import HOST_MEM, MachineModel

from .events import EventQueue
from .metrics import Metrics


class TransferEngine:
    """Link timing + transfer routing for one engine."""

    __slots__ = (
        "events", "metrics", "mem_link", "link_free", "_link_lat", "_link_bw", "audit",
        "memory",
    )

    def __init__(
        self, machine: MachineModel, events: EventQueue, metrics: Metrics
    ) -> None:
        self.events = events
        self.metrics = metrics
        self.link_free: Dict[int, float] = {}
        # accelerator memory -> link group (first resource on that memory)
        self.mem_link: Dict[int, Optional[int]] = {}
        for r in machine.resources:
            if r.is_accelerator:
                self.mem_link.setdefault(r.mem, r.link)
        self._link_lat = machine.link.latency
        self._link_bw = machine.link.bandwidth
        self.audit = None  # repro_torch.verify AuditLog, wired by the engine
        self.memory = None  # MemoryManager, wired by the engine when bounded

    def one_hop(self, nbytes: int, group: Optional[int], t: float, kind: str = "copy") -> float:
        """Serialize the transfer on its link group (FIFO = shared bandwidth)."""
        start = max(t, self.link_free.get(group, 0.0)) if group is not None else t
        dur = 0.0 if nbytes <= 0 else self._link_lat + nbytes / self._link_bw
        done = start + dur
        if group is not None:
            self.link_free[group] = done
        self.metrics.total_bytes += nbytes
        self.metrics.n_transfers += 1
        if self.audit is not None:
            self.audit.log_hop(kind, nbytes, group, t, done)
        return done

    def request(
        self, ctx, name: str, size: int, dst_mem: int, now: float, protect=None
    ) -> Optional[float]:
        """Ensure a valid copy of ``name`` will exist at ``dst_mem``.

        Returns the completion time, or None if already resident.
        ``protect`` (capacity-bounded runs) names data ids of ``ctx`` that
        the reservation's eviction pass must not victimize: the
        requesting task's own working set.
        """
        mask = ctx.residency._mask.get(name, 0)
        if mask & (1 << (dst_mem + 1)):
            return None  # already resident
        inflight = ctx.inflight
        flights = inflight.get(name)
        if flights is not None:
            done = flights.get(dst_mem)
            if done is not None:
                return done
        if mask == 0:
            raise RuntimeError(f"no valid copy of {name} anywhere")
        if self.memory is not None and dst_mem != HOST_MEM:
            # reserve destination space first: eviction write-backs queue
            # on the link ahead of this copy
            self.memory.reserve(ctx, name, size, dst_mem, now, protect)
        mem_link = self.mem_link
        post = self.events.post
        if (mask & 1) and dst_mem != HOST_MEM:
            # a host copy exists: single host->device hop
            done = self.one_hop(size, mem_link.get(dst_mem), now)
        elif dst_mem == HOST_MEM:
            src = (mask & -mask).bit_length() - 2  # lowest-numbered location
            done = self.one_hop(size, mem_link.get(src), now)
        else:
            # GPU -> host -> GPU (two hops, paper-era PCIe path)
            src = (mask & -mask).bit_length() - 2
            if flights is not None and HOST_MEM in flights:
                mid = flights[HOST_MEM]
            else:
                mid = self.one_hop(size, mem_link.get(src), now)
                if flights is None:
                    flights = inflight[name] = {}
                flights[HOST_MEM] = mid
                post(mid, "xfer", (ctx, name, HOST_MEM))
                if self.audit is not None:
                    self.audit.note_request(ctx.gid, name, HOST_MEM, mid, now)
            done = self.one_hop(size, mem_link.get(dst_mem), mid)
        if flights is None:
            flights = inflight[name] = {}
        flights[dst_mem] = done
        post(done, "xfer", (ctx, name, dst_mem))
        if self.audit is not None:
            self.audit.note_request(ctx.gid, name, dst_mem, done, now)
        return done

    def prefetch(self, ctx, task, mem: int, bit: int, now: float) -> None:
        """Start transfers for every non-resident input of ``task``."""
        mask_list = ctx.residency.mask_list
        inflight = ctx.inflight
        reads = ctx.arrays.task_reads[task.tid]
        protect = None
        for did, name, size in reads:
            if not mask_list[did] & bit:
                fl = inflight.get(name)
                if fl is None or mem not in fl:
                    if protect is None and self.memory is not None:
                        protect = frozenset(d for d, _, _ in reads)
                    self.request(ctx, name, size, mem, now, protect)
