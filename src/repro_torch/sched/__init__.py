"""``repro_torch.sched`` — the policy registry with the built-in policies
``heft``, ``dada``, ``dual`` and ``ws`` (``resolve("dada?alpha=0.5&use_cp=1")``)."""
from ..core.dada import DADA, DualApprox
from ..core.heft import HEFT
from ..runtime.queues import WorkSteal
from .registry import get_factory, parse_spec, register, registered, resolve

register("heft", HEFT)
register("dada", DADA)
register("dual", DualApprox)
register("ws", WorkSteal)

__all__ = ["get_factory", "parse_spec", "register", "registered", "resolve"]
