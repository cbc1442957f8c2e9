"""metrics-hygiene: serve-tier stats keys and registry metric names
stay consistent with their declarations and their documentation — the
port's copy of ``raft_tpu/analysis/rules/metrics.py``.  The port exports
the JAX package's metric names, so docs/serving.md's table is its table
too.

Two checks (docs/observability.md describes the conventions):

1. **declared stats keys** (per module) — a serve class whose ``stats``
   dict is a registry ``stats_view("<prefix>", {...})`` gets Prometheus
   counters ONLY for the keys in that literal init dict; a later bump
   of a brand-new literal key (``self.stats["new_thing"] += 1``)
   creates the counter lazily at first increment, which means the
   metric is invisible to ``/metricz`` scrapes until the first event —
   exactly the window where an operator concludes "that failure mode
   never happens".  Every literal-key bump must therefore name a key
   of the init dict.  Dynamic subscripts (``self.stats[status]``) are
   exempt: terminal-status counters are a *documented family*
   (``raft_tpu_torch_<prefix>_<status>_total``), created
   on first observation by design.
2. **documented metric names** (cross-module) — every literal metric
   name registered via ``.counter(...)``/``.gauge(...)``/
   ``.histogram(...)`` in the serve/obs tier must have a row in
   the "## Metrics" table, and every concrete name in
   that table must still be registered by some module — both
   directions, so the table tracks the code.  Rows spelled with a
   ``<placeholder>`` segment are family rows; they cover every
   stats-view-derived name they match.
"""

import ast
import re

from raft_tpu_torch.analysis.core import Finding, Rule

DOCS = "docs/torch_port.md"
PREFIX = "raft_tpu_torch_"
METRICS_HEADING = "## Metrics"

#: modules whose registry calls own a docs row
_NAME_SCOPES = ("raft_tpu_torch/serve/", "raft_tpu_torch/obs/")

_REGISTRY_METHODS = ("counter", "gauge", "histogram")

_ROW_NAME_RE = re.compile(r"raft_tpu_torch_[a-z0-9_<>]+")


def _stats_view_call(node):
    """(prefix, init-dict) when node is ``<x>.stats_view("p", {...})``,
    else None."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "stats_view"
            and len(node.args) >= 2
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)):
        return None
    try:
        init = ast.literal_eval(node.args[1])
    except (ValueError, SyntaxError):
        return None
    if not isinstance(init, dict):
        return None
    return node.args[0].value, init


def _counter_keys(init):
    """The init-dict keys that become registry counters (the
    StatsView contract: int and not bool)."""
    return {k for k, v in init.items()
            if isinstance(v, int) and not isinstance(v, bool)}


def registered_names(project):
    """Every literal metric name passed to a registry
    ``counter``/``gauge``/``histogram`` call in the serve/obs tier,
    plus the stats-view prefixes and their derived counter names:
    ``(names, derived, prefixes)`` where names/derived map
    name -> (rel, lineno)."""
    names, derived, prefixes = {}, {}, {}
    for module in project.modules.values():
        if not module.rel.startswith(_NAME_SCOPES):
            continue
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            sv = _stats_view_call(node)
            if sv is not None:
                prefix, init = sv
                prefixes.setdefault(prefix, (module.rel, node.lineno))
                for key in _counter_keys(init):
                    derived.setdefault(
                        f"{PREFIX}{prefix}_{key}_total",
                        (module.rel, node.lineno))
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _REGISTRY_METHODS
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and node.args[0].value.startswith(PREFIX)):
                names.setdefault(node.args[0].value,
                                 (module.rel, node.lineno))
    return names, derived, prefixes


def doc_metric_rows(text):
    """Names in the "## Metrics" table of docs/torch_port.md:
    ``(exact, families)`` — families are rows with a ``<placeholder>``
    segment, returned as compiled regexes matching whole names."""
    exact, families = set(), []
    in_section = False
    for line in (text or "").splitlines():
        if line.startswith("## "):
            in_section = line.strip() == METRICS_HEADING
            continue
        if not in_section or not line.lstrip().startswith("|"):
            continue
        for name in _ROW_NAME_RE.findall(line):
            if "<" in name:
                pat = "".join(
                    "[a-z0-9_]+" if part.startswith("<")
                    else re.escape(part)
                    for part in re.split(r"(<[a-z_]+>)", name))
                families.append(re.compile(pat + r"\Z"))
            else:
                exact.add(name)
    return exact, families


class MetricsHygiene(Rule):
    """See module docstring."""

    name = "metrics-hygiene"
    scope = ("raft_tpu_torch/serve/engine.py",
             "raft_tpu_torch/serve/router.py",
             "raft_tpu_torch/serve/autoscale.py")
    describe = ("stats-view keys are declared before they are bumped; "
                "registry metric names and the docs/serving.md metrics "
                "table track each other")

    # ---------------------------------------------------- check 1

    def check(self, tree, source, path):
        findings = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(node, path))
        return findings

    def _check_class(self, cls_node, path):
        declared = None
        for node in ast.walk(cls_node):
            if not isinstance(node, ast.Assign):
                continue
            sv = _stats_view_call(node.value)
            if sv is not None:
                declared = set(sv[1])
                break
        if declared is None:
            return []          # class keeps a plain stats dict (or none)
        findings = []
        for node in ast.walk(cls_node):
            if isinstance(node, ast.AugAssign):
                targets = [node.target]
            elif isinstance(node, ast.Assign):
                targets = node.targets
            else:
                continue
            for t in targets:
                key = self._stats_literal_key(t)
                if key is not None and key not in declared:
                    findings.append(Finding(
                        rule=self.name, path=path, line=node.lineno,
                        ident=f"{cls_node.name}:{key}",
                        message=f"{cls_node.name} bumps "
                                f"self.stats[{key!r}] but the "
                                "stats_view init dict never declares "
                                "it — the counter would not exist "
                                "until first bump, so /metricz scrapes "
                                "miss it (declare the key, or use a "
                                "dynamic subscript if it is a "
                                "documented status family)"))
        return findings

    @staticmethod
    def _stats_literal_key(target):
        """'key' when target is ``self.stats["key"]``, else None."""
        if (isinstance(target, ast.Subscript)
                and isinstance(target.value, ast.Attribute)
                and target.value.attr == "stats"
                and isinstance(target.value.value, ast.Name)
                and target.value.value.id == "self"
                and isinstance(target.slice, ast.Constant)
                and isinstance(target.slice.value, str)):
            return target.slice.value
        return None

    # ---------------------------------------------------- check 2

    def finalize(self, project):
        findings = []
        names, derived, prefixes = registered_names(project)
        text = project.read_text(DOCS)
        if text is None or METRICS_HEADING not in text:
            findings.append(Finding(
                rule=self.name, path=DOCS, line=1,
                ident="missing-metrics-table",
                message=f"{DOCS} has no '{METRICS_HEADING}' section — "
                        "the registry/docs cross-check has no table "
                        "to read"))
            return findings
        exact, families = doc_metric_rows(text)

        def covered(name):
            return name in exact or any(f.match(name) for f in families)

        for name, (rel, lineno) in sorted(names.items()):
            if not covered(name):
                findings.append(Finding(
                    rule=self.name, path=rel, line=lineno, ident=name,
                    message=f"metric {name} is registered here but has "
                            f"no row in {DOCS}'s metrics table"))
        for name, (rel, lineno) in sorted(derived.items()):
            if not covered(name):
                findings.append(Finding(
                    rule=self.name, path=rel, line=lineno, ident=name,
                    message=f"stats-view counter {name} (derived from "
                            "this init dict) has no row — add it, or a "
                            f"<placeholder> family row, to {DOCS}"))
        live = set(names) | set(derived)
        for name in sorted(exact):
            if name not in live:
                findings.append(Finding(
                    rule=self.name, path=DOCS, line=1,
                    ident=f"{name}:doc-stale",
                    message=f"{DOCS} documents metric {name} but no "
                            "serve/obs module registers it — retire "
                            "the row"))
        for fam in families:
            if not any(fam.match(n) for n in live):
                findings.append(Finding(
                    rule=self.name, path=DOCS, line=1,
                    ident=f"{fam.pattern}:doc-stale",
                    message=f"{DOCS} documents metric family "
                            f"{fam.pattern} but no stats view derives "
                            "a matching counter — retire the row"))
        return findings
