"""``repro_torch.sched`` — the policy API: the registry
(``resolve("dada?alpha=0.5&use_cp=1")``, ``register``, ``unregister``), the
:class:`Policy` protocol, the generic :class:`ScoreMatrixPolicy` driver and
:func:`assign_from_scores`. Built-in policies: the paper's ``heft``,
``dada``, ``dual`` and ``ws``, and the score-matrix policies ``random``,
``locality``, ``priority`` and ``wfq``."""
from ..core.dada import DADA, DualApprox
from ..core.heft import HEFT
from ..runtime.queues import WorkSteal
from .policies import LocalityPolicy, PriorityPolicy, RandomPolicy, WFQPolicy
from .policy import Policy, ScoreMatrixPolicy, assign_from_scores, class_duration_matrix
from .registry import (get_factory, parse_spec, register, registered, resolve, resolve_on,
                       unregister)

register("heft", HEFT)
register("dada", DADA)
register("dual", DualApprox)
register("ws", WorkSteal)
register("random", RandomPolicy)
register("locality", LocalityPolicy)
register("priority", PriorityPolicy)
register("wfq", WFQPolicy)

__all__ = [
    "LocalityPolicy", "Policy", "PriorityPolicy", "RandomPolicy", "ScoreMatrixPolicy",
    "WFQPolicy", "assign_from_scores", "class_duration_matrix", "get_factory", "parse_spec",
    "register", "registered", "resolve", "resolve_on", "unregister",
]
