"""allowlist-hygiene: the allowlists themselves are held to a contract
(the port's copy of ``raft_tpu/analysis/rules/hygiene.py``).

Every entry in ``raft_tpu_torch/analysis/allowlists/*.txt`` must carry a
reason (``<key>  # why``) and a well-formed ``path::ident`` key; a
file for a rule that is not registered is flagged too.  Stale entries
(keys matching no live finding) are detected by the runner, which has
the raw findings in hand — both kinds report under this rule's name,
so one allowlist policy shows up in one place.
"""

import os

from raft_tpu_torch.analysis.core import (DEFAULT_ALLOWLIST_DIR, Finding,
                                    Rule, load_allowlist)


class AllowlistHygiene(Rule):
    """See module docstring."""

    name = "allowlist-hygiene"
    scope = ()
    describe = ("every allowlist entry carries a reason and a "
                "well-formed key; no orphan allowlist files")

    def __init__(self, allowlist_dir=None):
        self.allowlist_dir = allowlist_dir or DEFAULT_ALLOWLIST_DIR

    def finalize(self, project):
        findings = []
        if not os.path.isdir(self.allowlist_dir):
            return findings
        from raft_tpu_torch.analysis.rules import ALL_RULES
        known = {r.name for r in ALL_RULES}
        for fname in sorted(os.listdir(self.allowlist_dir)):
            if not fname.endswith(".txt"):
                continue
            rule_name = fname[:-4]
            rel = f"raft_tpu_torch/analysis/allowlists/{fname}"
            if rule_name not in known:
                findings.append(Finding(
                    rule=self.name, path=rel, line=1,
                    ident=f"orphan:{rule_name}",
                    message=f"allowlist file {fname} matches no "
                            "registered rule"))
                continue
            entries, problems = load_allowlist(rule_name,
                                               self.allowlist_dir)
            findings.extend(problems)
            for e in entries:
                if "::" not in e.key:
                    findings.append(Finding(
                        rule=self.name, path=rel, line=e.lineno,
                        ident=f"{rule_name}:{e.key}",
                        message=f"allowlist key '{e.key}' is not of "
                                "the form <path>::<ident>"))
        return findings
