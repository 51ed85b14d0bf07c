"""Build the port's graphs and machines from plain descriptions.

A description holds only Python numbers, strings and tuples, so a graph
or machine built elsewhere (``repro``'s, a file, a generator) crosses into
this package without importing its source:

  graph spec    a sequence of tasks, in program order, each a mapping
                ``{"kind": str, "flops": float, "tag": any,
                "accesses": [(data name, size in bytes, mode), ...]}``
                with mode ``"r"``, ``"w"`` or ``"rw"``;
  machine spec  ``{"classes": {name: {"rates": {kind: FLOP/s},
                "default_rate": FLOP/s}}, "resources": [(class name,
                memory id, link group or None), ...], "bandwidth": bytes/s,
                "latency": s}`` — resource ids are list positions, memory
                id ``-1`` is host memory.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

from .core.dag import DataObject, Mode, TaskGraph
from .core.machine import LinkModel, MachineModel, Resource, ResourceClass


def graph_from_spec(tasks: Sequence[Mapping[str, Any]]) -> TaskGraph:
    """The :class:`TaskGraph` described by ``tasks`` (dependencies follow
    from the access modes in program order)."""
    g = TaskGraph()
    for t in tasks:
        accesses = [
            (DataObject(name, int(size)), Mode(mode))
            for name, size, mode in t["accesses"]
        ]
        g.add_task(t["kind"], accesses, flops=float(t["flops"]), tag=t.get("tag"))
    return g


def machine_from_spec(spec: Mapping[str, Any]) -> MachineModel:
    """The :class:`MachineModel` described by ``spec``."""
    classes: Dict[str, ResourceClass] = {
        name: ResourceClass(
            name=name,
            rates={k: float(v) for k, v in c["rates"].items()},
            default_rate=float(c["default_rate"]),
        )
        for name, c in spec["classes"].items()
    }
    resources = [
        Resource(rid, classes[cls], int(mem), None if link is None else int(link))
        for rid, (cls, mem, link) in enumerate(spec["resources"])
    ]
    return MachineModel(
        resources=resources,
        link=LinkModel(
            bandwidth=float(spec["bandwidth"]), latency=float(spec["latency"])
        ),
    )
