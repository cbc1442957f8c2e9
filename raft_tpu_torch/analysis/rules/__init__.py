"""Rule registry of the port's analysis: every shipped rule, in catalog
order.  Register a rule by appending an instance to ``ALL_RULES``: the
CLI and the parametrized test iterate this list."""

from raft_tpu_torch.analysis.rules.hygiene import AllowlistHygiene
from raft_tpu_torch.analysis.rules.legacy import (
    AutogradFunctionRegistered, BareExcept, BatchedPrepRegistered,
    ChaosRegistered, FixedPorts, KernelParityRegistered)
from raft_tpu_torch.analysis.rules.locks import LockDiscipline
from raft_tpu_torch.analysis.rules.metrics import MetricsHygiene
from raft_tpu_torch.analysis.rules.net import SocketTimeoutDiscipline
from raft_tpu_torch.analysis.rules.port import NoEnvFlags, PortIndependence

ALL_RULES = [
    PortIndependence(),
    NoEnvFlags(),
    LockDiscipline(),
    MetricsHygiene(),
    BareExcept(),
    FixedPorts(),
    KernelParityRegistered(),
    AutogradFunctionRegistered(),
    BatchedPrepRegistered(),
    ChaosRegistered(),
    SocketTimeoutDiscipline(),
    AllowlistHygiene(),
]


def rule_by_name(name):
    for rule in ALL_RULES:
        if rule.name == name:
            return rule
    raise KeyError(f"no rule named {name!r}; registered: "
                   f"{[r.name for r in ALL_RULES]}")
