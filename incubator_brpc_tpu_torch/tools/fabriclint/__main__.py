"""CLI: ``python -m incubator_brpc_tpu_torch.tools.fabriclint``.

Runs all five passes over the port and prints violations one per line
(``path:line: [rule] message``); exits 1 when any survive their
annotations.  ``--rule <name>`` filters the output to one rule family;
``--list-rules`` prints the rule ids; ``--json`` emits the
``{rule, file, line, reason}`` record array for diffing across commits.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from incubator_brpc_tpu_torch.tools.fabriclint import RULES, run_all, to_records

    ap = argparse.ArgumentParser(prog="fabriclint")
    ap.add_argument("--rule", help="only report this rule id")
    ap.add_argument(
        "--list-rules", action="store_true", help="print rule ids and exit"
    )
    ap.add_argument(
        "--json", action="store_true",
        help="emit {rule, file, line, reason} records as a JSON array",
    )
    args = ap.parse_args(argv)
    if args.list_rules:
        for r in RULES:
            print(r)
        return 0
    violations = run_all()
    if args.rule:
        violations = [v for v in violations if v.rule == args.rule]
    if args.json:
        print(json.dumps(to_records(violations), indent=2))
        return 1 if violations else 0
    for v in violations:
        print(v)
    if violations:
        print(f"fabriclint: {len(violations)} violation(s)", file=sys.stderr)
        return 1
    print("fabriclint: clean", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
