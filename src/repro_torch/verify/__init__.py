"""The audit log and the independent schedule verifier.

- :mod:`repro_torch.verify.audit`: the records an engine emits when it
  audits a run (the exact engine with ``audit=True``; the surrogate
  through :func:`repro_torch.core.episode.episode_audit_logs`), and their
  JSONL form, which is ``repro.verify``'s field for field.
- :mod:`repro_torch.verify.schedule`: :func:`verify_audit` rebuilds a
  residency timeline from the log alone (stdlib only, no engine code)
  and re-checks precedence, data hazards, capacity, byte conservation,
  exactly-once execution and dead-worker windows from first principles.

``python -m repro_torch.verify schedule A.jsonl [...]`` verifies logs
written with :meth:`AuditLog.to_jsonl`. ``repro.verify``'s lint has no
counterpart here: it lints ``repro``'s own JAX code.
"""

from .audit import AuditLog, graph_accesses
from .schedule import Finding, errors, verify_audit

__all__ = ["AuditLog", "Finding", "errors", "graph_accesses", "verify_audit"]
