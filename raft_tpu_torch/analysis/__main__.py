"""CLI: ``python -m raft_tpu_torch.analysis [--rule NAME] [--json] [--list]``.

Exit status 0 iff every registered rule reports zero unallowlisted
findings (the same condition the parametrized tier-1 test enforces).
"""

import argparse
import json
import sys

from raft_tpu_torch.analysis import ALL_RULES, analyze, rule_by_name


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.analysis",
        description="static analysis of the port")
    ap.add_argument("--rule", action="append", default=None,
                    metavar="NAME",
                    help="run only this rule (repeatable)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--list", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list:
        for rule in ALL_RULES:
            print(f"{rule.name:28s} {rule.describe}")
        return 0

    rules = ([rule_by_name(n) for n in args.rule]
             if args.rule else None)
    report = analyze(rules=rules)

    if args.json:
        print(json.dumps(report.to_doc(), indent=2, sort_keys=True))
    else:
        for finding in report.findings:
            print(finding)
        n_rules = len(report.reports)
        print(f"{n_rules} rule(s), {len(report.findings)} finding(s), "
              f"{report.n_allowlisted} allowlisted", file=sys.stderr)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
