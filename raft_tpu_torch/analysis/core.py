"""Rule protocol, allowlists, and the analysis runner — the port's own
copy of ``raft_tpu/analysis/core.py`` (the port imports nothing of the
JAX package).

A rule is a named object with a ``scope`` (repo-relative glob list) and
a ``check(tree, source, path)`` hook called once per in-scope module;
cross-module rules override ``finalize(project)`` instead (or as well).
Rules return :class:`Finding` lists; the runner filters findings
through the rule's allowlist and reports what survives.

Allowlists live in ``raft_tpu_torch/analysis/allowlists/<rule>.txt``, one
entry per line::

    <path>::<ident>  # <reason why this finding is intentional>

The reason is REQUIRED — an entry without one is itself reported as a
finding of the ``allowlist-hygiene`` rule, as is a stale entry that no
longer matches any live finding.  ``<ident>`` is the rule's stable key
for the finding (a qualname, a flag name — never a line number), so
allowlists survive unrelated edits.
"""

import ast
import fnmatch
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_ALLOWLIST_DIR = os.path.join(HERE, "allowlists")


@dataclass
class Finding:
    """One rule violation at a stable, allowlistable key."""

    rule: str
    path: str                  # repo-relative, '/'-separated
    line: int
    ident: str                 # stable token within the file (no lineno)
    message: str

    @property
    def key(self):
        return f"{self.path}::{self.ident}"

    def to_doc(self):
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "ident": self.ident, "key": self.key,
                "message": self.message}

    def __str__(self):
        return (f"[{self.rule}] {self.path}:{self.line}: {self.message}"
                f"  (allowlist key: {self.key})")


class Rule:
    """Base class; subclasses set ``name``/``scope`` and override one or
    both hooks."""

    name = "unnamed"
    #: repo-relative globs this rule's per-module hook sees
    scope = ("**/*.py",)
    #: one-line description for the CLI catalog
    describe = ""

    def in_scope(self, rel):
        return any(fnmatch.fnmatch(rel, pat) for pat in self.scope)

    def check(self, tree, source, path):
        """Per-module hook: AST + raw source + repo-relative path."""
        return []

    def finalize(self, project):
        """Cross-module hook, called once after every ``check``."""
        return []


@dataclass
class AllowlistEntry:
    key: str
    reason: str
    lineno: int


def load_allowlist(rule_name, allowlist_dir=None):
    """(entries, format-problem findings) for one rule."""
    path = os.path.join(allowlist_dir or DEFAULT_ALLOWLIST_DIR,
                        rule_name + ".txt")
    entries, problems = [], []
    if not os.path.exists(path):
        return entries, problems
    rel = "raft_tpu_torch/analysis/allowlists/" + rule_name + ".txt"
    with open(path, encoding="utf-8") as fh:
        for lineno, raw in enumerate(fh, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            key, _, reason = line.partition("#")
            key, reason = key.strip(), reason.strip()
            if not reason:
                problems.append(Finding(
                    rule="allowlist-hygiene", path=rel, line=lineno,
                    ident=f"{rule_name}:{key}",
                    message=f"allowlist entry '{key}' for rule "
                            f"'{rule_name}' has no reason — append "
                            "'# why this is intentional'"))
                continue
            entries.append(AllowlistEntry(key=key, reason=reason,
                                          lineno=lineno))
    return entries, problems


@dataclass
class RuleReport:
    rule: str
    findings: list = field(default_factory=list)      # unallowlisted
    allowlisted: list = field(default_factory=list)   # suppressed
    stale_allowlist: list = field(default_factory=list)


@dataclass
class AnalysisReport:
    reports: list = field(default_factory=list)       # [RuleReport]

    @property
    def findings(self):
        out = [f for r in self.reports for f in r.findings]
        for r in self.reports:
            out += r.stale_allowlist
        return out

    @property
    def n_allowlisted(self):
        return sum(len(r.allowlisted) for r in self.reports)

    @property
    def ok(self):
        return not self.findings

    def to_doc(self):
        return {
            "rules": [r.rule for r in self.reports],
            "n_rules": len(self.reports),
            "findings": [f.to_doc() for f in self.findings],
            "n_findings": len(self.findings),
            "n_allowlisted": self.n_allowlisted,
            "ok": self.ok,
        }


def run_rules(project, rules, allowlist_dir=None):
    """Run every rule over the project; returns an AnalysisReport."""
    report = AnalysisReport()
    for rule in rules:
        raw = []
        for module in project.modules.values():
            if rule.in_scope(module.rel):
                raw.extend(rule.check(module.tree, module.source,
                                      module.rel))
        raw.extend(rule.finalize(project))
        # format problems (missing reasons) are reported by the
        # allowlist-hygiene rule; here a reasonless entry simply does
        # not suppress, so its finding surfaces too
        entries, _problems = load_allowlist(rule.name, allowlist_dir)
        allowed = {e.key: e for e in entries}
        rr = RuleReport(rule=rule.name)
        used = set()
        for f in raw:
            if f.key in allowed:
                used.add(f.key)
                rr.allowlisted.append(f)
            else:
                rr.findings.append(f)
        for e in entries:
            if e.key not in used:
                rr.stale_allowlist.append(Finding(
                    rule="allowlist-hygiene",
                    path="raft_tpu_torch/analysis/allowlists/"
                         f"{rule.name}.txt",
                    line=e.lineno, ident=f"{rule.name}:{e.key}",
                    message=f"stale allowlist entry '{e.key}' for rule "
                            f"'{rule.name}' matches no live finding — "
                            "delete it"))
        report.reports.append(rr)
    return report


def parse_snippet(source):
    """Helper for fixture tests: (tree, source)."""
    return ast.parse(source), source
