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
copy by default: ``repro``'s engine keeps that modeling artifact, and
this engine matches it bit for bit. With ``cancel_stale`` (the engine's
``cancel_stale=True``) each request stamps its landing with the datum's
version, which the engine bumps at every write; a landing whose version
is stale is dropped instead.

Capacity-bounded memories (:mod:`repro_torch.runtime.memory`, wired by
the engine as ``memory``) hook in at request time: space at the
destination is reserved before the hop is scheduled, so any eviction
write-back the reservation triggers queues ahead of the incoming copy on
the same link. Unbounded runs never reach the hook.

Faults (:mod:`repro_torch.runtime.faults`, wired by the engine as
``faults``): each request records the destination memory's detach epoch
in its landing event, and a landing whose epoch is stale is dropped (the
copy died with the device).

Flaky links (:meth:`TransferEngine.enable_flake`, the engine's
``link_flake`` > 0): each demand hop fails with a seeded probability. A
failed hop held the link and is retried with capped exponential backoff
(``backoff_s``, doubling an attempt, capped at 64 times); past
``retry_max`` retries the transfer times out and is re-sourced, one final
reliable hop. Every attempt occupies the link and is charged as traffic.
The failures are drawn from a generator of their own, so a run without
flaky links consumes nothing of it.

With an audit log attached (``audit``, wired by the engine), every hop is
logged with its kind (``copy``; ``writeback`` for a dirty eviction;
``evacuate`` and ``proactive`` for a fault's salvage; ``retry`` and
``resource`` for a flaky hop's attempts) and every request notes its
time, so the landing record can carry it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.machine import HOST_MEM, MachineModel

from .events import EventQueue
from .metrics import Metrics

# the flake generator's stream key, disjoint from the engine's noise stream
# and the churn stream for every engine seed
_FLAKE_STREAM = 0xF1A4E


class TransferEngine:
    """Link timing + transfer routing for one engine."""

    __slots__ = (
        "events", "metrics", "mem_link", "link_free", "_link_lat", "_link_bw", "audit",
        "memory", "faults", "flake_rate", "retry_max", "backoff_s", "_flake_rng", "_flake_on",
        "cancel_stale",
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
        self.faults = None  # FaultManager, wired by the engine
        self.cancel_stale = False  # stamp landings with the data's version
        # flaky links (inert until enable_flake)
        self.flake_rate = 0.0
        self.retry_max = 0
        self.backoff_s = 0.0
        self._flake_rng: Optional[np.random.Generator] = None
        self._flake_on = False

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

    def enable_flake(self, rate: float, retry_max: int, backoff_s: float, seed: int) -> None:
        """Arm the seeded per-hop failure model (the engine calls this when
        ``link_flake`` > 0)."""
        if not (0.0 <= rate <= 1.0):
            raise ValueError(f"flake rate must be in [0, 1], got {rate}")
        if retry_max < 0:
            raise ValueError(f"retry_max must be >= 0, got {retry_max}")
        if backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {backoff_s}")
        self.flake_rate = float(rate)
        self.retry_max = int(retry_max)
        self.backoff_s = float(backoff_s)
        self._flake_rng = np.random.default_rng((int(seed) & 0xFFFFFFFF, _FLAKE_STREAM))
        self._flake_on = self.flake_rate > 0.0

    def _flaky_hop(self, ctx, name: str, nbytes: int, group: Optional[int], t: float,
                   dst_mem: int) -> float:
        """One demand hop under the flake model: retry with capped
        exponential backoff, re-source on timeout. The whole chain is
        priced at once (``one_hop`` occupies the link eagerly); only the
        final landing is posted."""
        done = self.one_hop(nbytes, group, t)
        attempt = 0
        rng = self._flake_rng
        rate = self.flake_rate
        metrics = self.metrics
        while rng.random() < rate:
            if attempt >= self.retry_max:
                # the retry budget is spent: the transfer times out and is
                # re-sourced, one final reliable hop
                metrics.n_timeouts += 1
                if self.audit is not None:
                    self.audit.log_timeout(ctx.gid, name, dst_mem, done, attempt + 1, nbytes)
                return self.one_hop(nbytes, group, done, kind="resource")
            attempt += 1
            delay = min(self.backoff_s * (2.0 ** (attempt - 1)), self.backoff_s * 64.0)
            metrics.n_retries += 1
            metrics.retry_delay_s += delay
            if self.audit is not None:
                self.audit.log_retry(ctx.gid, name, dst_mem, done, attempt, delay, nbytes)
            done = self.one_hop(nbytes, group, done + delay, kind="retry")
        return done

    def _hop(self, ctx, name: str, size: int, group: Optional[int], t: float,
             dst_mem: int) -> float:
        if self._flake_on:
            return self._flaky_hop(ctx, name, size, group, t, dst_mem)
        return self.one_hop(size, group, t)

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
        ver = ctx.data_version.get(name, 0) if self.cancel_stale else 0
        # the destination memory's detach epoch: 0 while no fault source is
        # active (the host never detaches, so host hops carry 0)
        faults = self.faults
        epoch = faults.mem_epoch.get(dst_mem, 0) if faults is not None and faults.active else 0
        mem_link = self.mem_link
        post = self.events.post
        if (mask & 1) and dst_mem != HOST_MEM:
            # a host copy exists: single host->device hop
            done = self._hop(ctx, name, size, mem_link.get(dst_mem), now, dst_mem)
        elif dst_mem == HOST_MEM:
            src = (mask & -mask).bit_length() - 2  # lowest-numbered location
            done = self._hop(ctx, name, size, mem_link.get(src), now, HOST_MEM)
        else:
            # GPU -> host -> GPU (two hops, paper-era PCIe path)
            src = (mask & -mask).bit_length() - 2
            if flights is not None and HOST_MEM in flights:
                mid = flights[HOST_MEM]
            else:
                mid = self._hop(ctx, name, size, mem_link.get(src), now, HOST_MEM)
                if flights is None:
                    flights = inflight[name] = {}
                flights[HOST_MEM] = mid
                post(mid, "xfer", (ctx, name, HOST_MEM, ver, 0))
                if self.audit is not None:
                    self.audit.note_request(ctx.gid, name, HOST_MEM, mid, now)
            done = self._hop(ctx, name, size, mem_link.get(dst_mem), mid, dst_mem)
        if flights is None:
            flights = inflight[name] = {}
        flights[dst_mem] = done
        post(done, "xfer", (ctx, name, dst_mem, ver, epoch))
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
