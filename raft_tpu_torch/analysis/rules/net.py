"""socket-timeout-discipline: every outbound network call in the
port must pass an explicit timeout (the port's copy of
``raft_tpu/analysis/rules/net.py``).

A blocking stdlib network call with no timeout inherits the global
default (None = forever): one gray-failing peer — a host that accepts
the TCP connection and then never answers, exactly what the
``net_partition`` chaos fault models — wedges the calling thread for
good, and a router forwarding pool wedges one thread per retry until
the fleet stops serving.  The repo's resilience story (breakers,
retry-on-next-replica, scrape staleness) only works because every wire
wait is bounded, so the bound must be visible AT THE CALL SITE, not
inherited from ambient state.

Flagged callees and where their timeout may appear::

    urlopen(url, data, timeout)            kwarg or positional #3
    http.client.HTTPConnection(h, p, t)    kwarg or positional #3
    http.client.HTTPSConnection(h, p, t)   kwarg or positional #3
    socket.create_connection(addr, t)      kwarg or positional #2

A call passing the timeout positionally counts; forwarding a variable
(``timeout=self.timeout``) counts — the rule checks that the decision
was made, not what it was.  Intentional exceptions go in
``raft_tpu_torch/analysis/allowlists/socket-timeout-discipline.txt`` with a
reason (reasons are REQUIRED — allowlist-hygiene rejects bare
entries).
"""

import ast

from raft_tpu_torch.analysis.core import Finding, Rule
from raft_tpu_torch.analysis.project import callee_name
from raft_tpu_torch.analysis.rules.legacy import qualname_of

#: callee -> number of positional args after which the timeout slot is
#: covered positionally (``urlopen(url, data, 5.0)`` has 3)
_NET_CALLEES = {
    "urlopen": 3,
    "HTTPConnection": 3,
    "HTTPSConnection": 3,
    "create_connection": 2,
}


class SocketTimeoutDiscipline(Rule):
    """Every urlopen/http.client/socket call site must pass an
    explicit timeout (see module docstring)."""

    name = "socket-timeout-discipline"
    scope = ("raft_tpu_torch/*.py", "chip_smoke.py")
    describe = ("every outbound network call passes an explicit "
                "timeout (no unbounded blocking on a gray peer)")

    def check(self, tree, source, path):
        findings = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            callee = callee_name(node)
            slot = _NET_CALLEES.get(callee)
            if slot is None:
                continue
            if any(kw.arg == "timeout" for kw in node.keywords):
                continue
            if len(node.args) >= slot:
                continue               # timeout passed positionally
            if any(kw.arg is None for kw in node.keywords):
                continue               # **kw expansion may carry it
            qual = qualname_of(tree, node.lineno)
            findings.append(Finding(
                rule=self.name, path=path, line=node.lineno,
                ident=f"{qual}:{callee}",
                message=f"`{callee}(...)` in {qual} passes no timeout "
                        "— an unanswering peer blocks this thread "
                        "forever; pass timeout= explicitly"))
        return findings
