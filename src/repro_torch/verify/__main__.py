"""Verify audit logs from the command line.

    python -m repro_torch.verify schedule AUDIT.jsonl [more.jsonl...]

Verifies logs written with ``AuditLog.to_jsonl`` (by either package) and
prints each finding and a summary line per log. Exits 1 when any log has
an error or cannot be read; warnings are printed but do not fail.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .audit import AuditLog
from .schedule import errors, verify_audit


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.verify", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_sched = sub.add_parser("schedule", help="verify audit-log JSONL files")
    p_sched.add_argument("logs", nargs="+", help="audit logs written by AuditLog.to_jsonl")
    args = parser.parse_args(argv)

    failed = False
    for path in args.logs:
        try:
            log = AuditLog.from_jsonl(path)
        except (OSError, ValueError) as exc:
            print(f"{path}: unreadable audit log: {exc}")
            failed = True
            continue
        findings = verify_audit(log)
        errs = errors(findings)
        for f in findings:
            print(f"{path}: {f}")
        print(
            f"{path}: engine={log.engine} "
            f"{len(errs)} error(s), {len(findings) - len(errs)} warning(s)"
        )
        failed = failed or bool(errs)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
