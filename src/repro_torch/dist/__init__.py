"""Distribution layer: the scheduler bridge, elasticity, stragglers.

Counterpart of ``repro/dist`` for its numpy planners: ``sched_bridge``
maps the policy score mechanism (``repro_torch.sched.assign_from_scores``)
to expert and pipeline-stage placement, with the capacity-pressure
eviction cost shared with ``repro_torch.runtime.memory``; ``elastic``
re-plans mesh and expert placement after device-count changes (and, via
``ElasticReplanner``, follows a live fault-injected engine's detach /
attach stream); ``straggler`` re-balances micro-batches from observed
step times. The sharding rules (``repro/dist/sharding.py``) wait for
the port's multi-device path (``ROADMAP.md``, queue 1 item 9).
"""
from . import elastic, sched_bridge, straggler

__all__ = ["elastic", "sched_bridge", "straggler"]
