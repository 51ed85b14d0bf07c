"""JSONL preemption traces: replayable detach/attach schedules.

Counterpart of ``repro.runtime.traces``. One JSON object a line,
``{"t": <seconds>, "event": "detach"|"attach", "rid": <id>}``, drives the
fault layer (:mod:`repro_torch.runtime.faults`) directly, so a recorded
churn timeline replays against the simulator deterministically.

Schema v2:

  * ``t``        — simulated seconds (non-negative number), required;
  * ``event``    — ``"detach"`` or ``"attach"``, required;
  * ``rid``      — resource id on the simulated machine (non-negative
    int), required;
  * ``mode``     — ``"drain"`` or ``"kill"``, optional, detach events
    only;
  * ``notice_s`` — advance-warning window in seconds (non-negative
    number), optional, detach events only: the detach is announced that
    long before ``t``. v1 lines omit the field and load unchanged.

Blank lines and lines starting with ``#`` are skipped. A malformed line
raises ``ValueError`` naming the file and the line number.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Union

FAULT_EVENTS = ("detach", "attach")
FAULT_MODES = ("drain", "kill")


@dataclass(frozen=True)
class FaultEvent:
    """One preemption-trace entry: (when, what, which resource)."""

    t: float
    event: str
    rid: int
    mode: Optional[str] = None
    notice_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.event not in FAULT_EVENTS:
            raise ValueError(f"fault event must be one of {FAULT_EVENTS}, got {self.event!r}")
        if self.mode is not None and self.mode not in FAULT_MODES:
            raise ValueError(f"fault mode must be one of {FAULT_MODES}, got {self.mode!r}")
        if not (self.t >= 0.0):
            raise ValueError(f"fault time must be >= 0, got {self.t!r}")
        if self.rid < 0:
            raise ValueError(f"fault rid must be >= 0, got {self.rid!r}")
        if self.notice_s is not None:
            if self.event != "detach":
                raise ValueError(
                    f"fault notice_s only applies to detach events, got event={self.event!r}"
                )
            if not (self.notice_s >= 0.0):
                raise ValueError(f"fault notice_s must be >= 0, got {self.notice_s!r}")


def _parse_entry(obj, where: str) -> FaultEvent:
    if not isinstance(obj, dict):
        raise ValueError(f"{where}: expected a JSON object, got {type(obj).__name__}")
    unknown = set(obj) - {"t", "event", "rid", "mode", "notice_s"}
    if unknown:
        raise ValueError(f"{where}: unknown trace field(s) {sorted(unknown)}")
    try:
        t, event, rid = obj["t"], obj["event"], obj["rid"]
    except KeyError as e:
        raise ValueError(f"{where}: missing required field {e.args[0]!r}") from None
    if isinstance(t, bool) or not isinstance(t, (int, float)):
        raise ValueError(f"{where}: 't' must be a number, got {t!r}")
    if isinstance(rid, bool) or not isinstance(rid, int):
        raise ValueError(f"{where}: 'rid' must be an integer, got {rid!r}")
    notice = obj.get("notice_s")
    if notice is not None and (isinstance(notice, bool) or not isinstance(notice, (int, float))):
        raise ValueError(f"{where}: 'notice_s' must be a number, got {notice!r}")
    try:
        return FaultEvent(float(t), event, rid, obj.get("mode"),
                          None if notice is None else float(notice))
    except ValueError as e:
        raise ValueError(f"{where}: {e}") from None


def load_trace(path: str) -> List[FaultEvent]:
    """Parse a JSONL preemption trace, sorted by time (stable). Raises
    ``ValueError`` with the file and line number on the first malformed
    line: a truncated trace must not replay half a schedule."""
    events: List[FaultEvent] = []
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            where = f"{path}:{lineno}"
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{where}: invalid JSON ({e.msg})") from None
            events.append(_parse_entry(obj, where))
    events.sort(key=lambda e: e.t)
    return events


def save_trace(events: Iterable[Union[FaultEvent, Sequence]], path: str) -> None:
    """Write fault events as a JSONL trace (the inverse of
    :func:`load_trace`). Takes :class:`FaultEvent` instances or ``(t,
    event, rid[, mode[, notice_s]])`` sequences, such as a
    :class:`~repro_torch.runtime.faults.FaultManager` history. Optional
    fields are written only when set, so v1 traces round-trip byte for
    byte."""
    with open(path, "w", encoding="utf-8") as fh:
        for ev in events:
            if not isinstance(ev, FaultEvent):
                ev = FaultEvent(*ev)
            obj = {"t": ev.t, "event": ev.event, "rid": ev.rid}
            if ev.mode is not None:
                obj["mode"] = ev.mode
            if ev.notice_s is not None:
                obj["notice_s"] = ev.notice_s
            fh.write(json.dumps(obj) + "\n")
