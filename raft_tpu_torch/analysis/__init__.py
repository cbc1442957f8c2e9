"""Static analysis of the port: the JAX package's lints
(``raft_tpu/analysis``) copied and scoped to ``raft_tpu_torch``, its
tests ``tests/test_torch_*.py`` and ``chip_smoke.py``, plus the port's
own rules (``kernel-parity-registered``, ``autograd-function-registered``,
``port-independence``, ``no-env-flags``).

Entry points:

* ``python -m raft_tpu_torch.analysis [--rule NAME] [--json] [--list]``
  — exit 0 iff no unallowlisted findings;
* ``tests/test_torch_analysis.py`` — one parametrized test per rule,
  plus fixture trees each new rule must catch;
* :func:`analyze` — the library call both use.

Everything is ``ast`` over source text: the code under analysis is never
imported, so it runs the same on a machine without jax or a card.
"""

import os

from raft_tpu_torch.analysis.core import (AnalysisReport, Finding, Rule,
                                          load_allowlist, run_rules)
from raft_tpu_torch.analysis.project import ProjectModel
from raft_tpu_torch.analysis.rules import ALL_RULES, rule_by_name

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def analyze(rules=None):
    """Run ``rules`` (default: all registered) over this repo; returns an
    :class:`AnalysisReport`."""
    return run_rules(ProjectModel(REPO_ROOT), rules or ALL_RULES)


__all__ = ["ALL_RULES", "AnalysisReport", "Finding", "ProjectModel",
           "Rule", "analyze", "load_allowlist", "rule_by_name",
           "run_rules"]
