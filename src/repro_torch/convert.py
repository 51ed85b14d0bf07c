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
                id ``-1`` is host memory;
  model params  the reference's parameter tree as nested dicts of numpy
                arrays (``jax.tree.map(np.asarray, params)``), see
                :func:`params_from_jax`.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from .core.dag import DataObject, Mode, TaskGraph
from .core.machine import LinkModel, MachineModel, Resource, ResourceClass
from .device import resolve_device


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


def params_from_jax(tree: Mapping[str, Any], cfg, device="cuda") -> Dict[str, Any]:
    """The port's parameters from the reference's tree (nested dicts of numpy
    arrays, as ``repro.models.transformer.init_params`` lays them out) for a
    config ``cfg`` the port serves: attention blocks GQA or MLA (``w_dq``,
    ``q_norm``, ``w_uq``, ``w_dkv``, ``kv_norm``, ``w_kr``, ``w_uk``,
    ``w_uv``, ``wo`` under each block's ``"mla"``), Mamba blocks (``w_in``,
    ``conv_w``, ``conv_b``, ``w_x``, ``w_dt``, ``dt_bias``, ``a_log``,
    ``d_skip``, ``w_out`` under ``"mamba"``), dense or MoE (``router``,
    ``w_up``, ``w_gate``, ``w_down`` under each block's ``"moe"`` in place
    of ``"mlp"``). Each pattern position's subtree ``p{j}`` has a leading
    ``n_periods`` axis; its entry ``k`` becomes layer ``period * k + j`` of
    a list of per-layer dicts. Every array is cast to the compute dtype on
    ``device``, the f32 router, ``a_log``, ``dt_bias`` and ``d_skip`` too
    (the reference's ``_cast_floats`` casts at every call; once gives the
    same numbers). bf16 numpy arrays (ml_dtypes) widen to f32 exactly on
    the way."""
    from .models.layers import _dtype
    from .models.transformer import check_supported

    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg.compute_dtype)

    def tensor(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(device=dev, dtype=dt)

    def layer(sub, k):
        return {n: layer(v, k) if isinstance(v, Mapping) else tensor(v[k]) for n, v in sub.items()}

    period = cfg.period
    blocks = [
        layer(tree["blocks"][f"p{i % period}"], i // period) for i in range(cfg.n_layers)
    ]
    out: Dict[str, Any] = {
        "embed": {"table": tensor(tree["embed"]["table"])},
        "final_norm": {k: tensor(v) for k, v in tree["final_norm"].items()},
        "blocks": blocks,
    }
    if "lm_head" in tree:
        out["lm_head"] = tensor(tree["lm_head"])
    return out
