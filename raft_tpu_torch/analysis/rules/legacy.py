"""The JAX package's lints on the Rule protocol, copied and scoped to the
port (``raft_tpu/analysis/rules/legacy.py``), and the port's kernel and
autograd registration lints in their pattern.

Copied: ``no-bare-except``, ``no-fixed-ports``, ``batched-prep-registered``
and ``chaos-registered``, with the same detection logic and allowlist
keys.  The port's own: ``kernel-parity-registered`` (the counterpart of
``pallas-parity-registered``) and ``autograd-function-registered`` (of
``custom-vjp-registered``).  The test registry also counts
``from pkg import mod`` as importing ``pkg.mod``.
"""

import ast
import re

from raft_tpu_torch.analysis.core import Finding, Rule
from raft_tpu_torch.analysis.project import callee_name

# ------------------------------------------------------------ bare except

# a call to any of these attribute/function names counts as handling
LOG_NAMES = {
    "print", "warn", "warning", "error", "exception", "info", "debug",
    "log", "critical", "fail", "skip", "xfail",
}
# an assignment/subscript target whose name contains one of these counts
# as recording a failure status
RECORD_MARKERS = ("error", "fail", "status", "reason", "exc", "bad",
                  "corrupt", "reject", "quarantine", "msg")


def _names_in(node):
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _target_marks_failure(target):
    if isinstance(target, ast.Name):
        name = target.id.lower()
    elif isinstance(target, ast.Attribute):
        name = target.attr.lower()
    elif isinstance(target, ast.Subscript):
        name = ""
        if isinstance(target.slice, ast.Constant) \
                and isinstance(target.slice.value, str):
            name = target.slice.value.lower()
        base = target.value
        if isinstance(base, ast.Name):
            name += " " + base.id.lower()
        elif isinstance(base, ast.Attribute):
            name += " " + base.attr.lower()
    else:
        return False
    return any(m in name for m in RECORD_MARKERS)


def _handler_handles(handler):
    """Whether an ``except Exception`` body re-raises, logs, or records
    the failure."""
    exc_name = handler.name
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.Assert)):
            return True
        if isinstance(node, ast.Call):
            if callee_name(node) in LOG_NAMES:
                return True
            if any(kw.arg in ("error", "status") for kw in node.keywords):
                return True
            if exc_name and any(exc_name in _names_in(a)
                                for a in node.args):
                return True
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets
                       if isinstance(node, ast.Assign) else [node.target])
            if any(_target_marks_failure(t) for t in targets):
                return True
            if exc_name and exc_name in _names_in(node):
                return True
        if isinstance(node, (ast.Return, ast.Yield)) \
                and node.value is not None:
            if exc_name and exc_name in _names_in(node.value):
                return True
    return False


def _broad_type(handler):
    """'bare', 'broad' (Exception/BaseException, alone or in a tuple),
    or None."""
    if handler.type is None:
        return "bare"
    types = (handler.type.elts if isinstance(handler.type, ast.Tuple)
             else [handler.type])
    for t in types:
        name = t.id if isinstance(t, ast.Name) else (
            t.attr if isinstance(t, ast.Attribute) else "")
        if name in ("Exception", "BaseException"):
            return "broad"
    return None


def qualname_of(tree, lineno):
    """Innermost enclosing function/class qualname for a line."""
    best = "<module>"
    best_span = None

    def visit(node, prefix):
        nonlocal best, best_span
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                end = getattr(child, "end_lineno", child.lineno)
                qual = (prefix + "." + child.name).lstrip(".")
                if child.lineno <= lineno <= end:
                    span = end - child.lineno
                    if best_span is None or span <= best_span:
                        best, best_span = qual, span
                    visit(child, qual)
            else:
                visit(child, prefix)

    visit(tree, "")
    return best


class BareExcept(Rule):
    """No bare ``except:`` ever; every ``except Exception`` must raise,
    log, or record a failure status."""

    name = "no-bare-except"
    scope = ("**/*.py", "*.py")
    describe = ("no bare `except:`; broad handlers must raise, log, or "
                "record a failure status")

    def check(self, tree, source, path):
        findings = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            kind = _broad_type(node)
            if kind is None:
                continue
            qual = qualname_of(tree, node.lineno)
            if kind == "bare":
                findings.append(Finding(
                    rule=self.name, path=path, line=node.lineno,
                    ident=f"{qual}:bare",
                    message="bare `except:` — catch a class, at minimum "
                            "`except Exception` with handling"))
                continue
            if _handler_handles(node):
                continue
            findings.append(Finding(
                rule=self.name, path=path, line=node.lineno, ident=qual,
                message=f"`except Exception` handler in {qual} neither "
                        "raises, logs, nor records a failure status"))
        return findings


# ------------------------------------------------------------ fixed ports

PORT_PATTERNS = [
    re.compile(r"""\(\s*["'](?:127\.0\.0\.1|0\.0\.0\.0|localhost|::1?)"""
               r"""["']\s*,\s*(\d+)\s*\)"""),
    re.compile(r"""\b(?:port|http_port)\s*=\s*(\d+)"""),
    re.compile(r"""["']--http["']\s*,\s*["'](\d+)["']"""),
    re.compile(r"""["'](?:127\.0\.0\.1|0\.0\.0\.0|localhost|\[::1?\])"""
               r""":(\d+)["']"""),
]

_PORT_ALLOW = "# port-lint: allow"


class FixedPorts(Rule):
    """Every server binds port 0 and reads the assigned port back — a
    literal TCP port anywhere is a CI port-collision flake waiting."""

    name = "no-fixed-ports"
    scope = ("tests/*.py", "*.py", "raft_tpu_torch/*.py")
    describe = "no fixed TCP port literals (bind port 0, read it back)"

    def check(self, tree, source, path):
        findings = []
        for lineno, line in enumerate(source.splitlines(), 1):
            if _PORT_ALLOW in line:
                continue
            for pat in PORT_PATTERNS:
                for m in pat.finditer(line):
                    if int(m.group(1)) != 0:
                        findings.append(Finding(
                            rule=self.name, path=path, line=lineno,
                            ident=m.group(0).strip(),
                            message=f"fixed TCP port literal "
                                    f"`{m.group(0).strip()}` — bind "
                                    "port 0 and read the assigned port "
                                    "back"))
        return findings


# ------------------------------------------- registration lints (4 of them)

def _test_registry(project, marker):
    """(imported modules, marker-test names) per test module."""
    registry = []
    for module in project.test_modules():
        imports = set()
        marked = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                imports.add(node.module)
                imports.update(f"{node.module}.{a.name}"
                               for a in node.names)
            elif isinstance(node, ast.Import):
                imports.update(a.name for a in node.names)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)) \
                    and node.name.startswith("test_") \
                    and marker in node.name:
                marked.append(node.name)
        registry.append((module.rel, imports, marked))
    return registry


class BatchedPrepRegistered(Rule):
    """Every multi-design prep driver must be covered by a registered
    ``test_*batched*`` test importing it."""

    name = "batched-prep-registered"
    scope = ()
    describe = ("every multi-design prep driver needs a registered "
                "test_*batched* test")
    solo_prep_calls = ("_prepare_design", "_prepare_design_point")
    prep_loop_defs = ("_sweep_prep_ahead_locked",)
    expected_modules = ("raft_tpu_torch.sweep",
                        "raft_tpu_torch.sweep_fused",
                        "raft_tpu_torch.serve.engine")

    def _driver_modules(self, project):
        mods = []
        for module in project.package_modules():
            hit = False
            for node in ast.walk(module.tree):
                if isinstance(node, ast.Call) \
                        and callee_name(node) in self.solo_prep_calls:
                    hit = True
                elif isinstance(node, ast.FunctionDef) \
                        and node.name in self.prep_loop_defs:
                    hit = True
                if hit:
                    break
            if hit:
                mods.append(module)
        return mods

    def finalize(self, project):
        return _registered(project, self, self._driver_modules(project),
                           self.expected_modules, ("batched",),
                           "drives multi-design prep")


class ChaosRegistered(Rule):
    """Every fault in ``raft_tpu_torch.chaos.FAULTS`` must be injected by at
    least one test (the fault name appears in a test file that defines
    tests)."""

    name = "chaos-registered"
    scope = ()
    describe = "every registered chaos fault needs a test injecting it"
    expected_faults = ("prep_raise", "nan_lane", "replica_kill",
                       "replica_slow", "conn_drop")

    def _registered_faults(self, project):
        module = project.module_by_dotted("raft_tpu_torch.chaos")
        if module is None:
            return None
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Assign):
                continue
            for target in node.targets:
                if isinstance(target, ast.Name) \
                        and target.id == "FAULTS":
                    try:
                        names = ast.literal_eval(node.value)
                    except ValueError:
                        return None
                    if isinstance(names, tuple) and names:
                        return names
        return None

    def finalize(self, project):
        faults = self._registered_faults(project)
        if faults is None:
            return [Finding(
                rule=self.name, path="raft_tpu_torch/chaos.py", line=1,
                ident="stale-probe:FAULTS",
                message="chaos.py no longer assigns a literal FAULTS "
                        "tuple; update this rule's probe")]
        findings = []
        for expected in self.expected_faults:
            if expected not in faults:
                findings.append(Finding(
                    rule=self.name, path="raft_tpu_torch/chaos.py", line=1,
                    ident=f"missing-fault:{expected}",
                    message=f"documented fault {expected!r} is no "
                            "longer in chaos.FAULTS"))
        # a test file naming the fault in any string constant counts —
        # faults are only reachable through a chaos spec string, so
        # injection necessarily spells the name
        registry = []
        for module in project.test_modules():
            if module.rel.endswith("test_torch_analysis.py"):
                continue        # the lint's own tests are not coverage
            strings = set()
            has_tests = False
            for node in ast.walk(module.tree):
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str):
                    strings.add(node.value)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)) \
                        and node.name.startswith("test_"):
                    has_tests = True
            registry.append((strings, has_tests))
        for fault in faults:
            covered = any(has_tests and any(fault in s for s in strings)
                          for strings, has_tests in registry)
            if not covered:
                findings.append(Finding(
                    rule=self.name, path="raft_tpu_torch/chaos.py", line=1,
                    ident=fault,
                    message=f"chaos fault {fault!r} has no test "
                            "injecting it (add a test with a chaos "
                            "spec naming it)"))
        return findings


def _registered(project, rule, mods, expected, marker_names, what):
    """Findings for a registration lint: each of ``mods`` must be imported
    by a test module defining a ``test_*<marker>*`` function, and each
    ``expected`` module must still be found by the probe."""
    findings = []
    dotted = {m.dotted for m in mods}
    for name in expected:
        if project.module_by_dotted(name) is not None \
                and name not in dotted:
            findings.append(Finding(
                rule=rule.name, path="raft_tpu_torch/analysis/rules/"
                "legacy.py", line=1, ident=f"stale-probe:{name}",
                message=f"{name} exists but the {what} probe no longer "
                        "finds it — update the rule"))
    registry = []
    for marker in marker_names:
        registry += _test_registry(project, marker)
    markers = "/".join(f"test_*{m}*" for m in marker_names)
    for module in mods:
        covered = any(module.dotted in imports and marked
                      for _, imports, marked in registry)
        if not covered:
            findings.append(Finding(
                rule=rule.name, path=module.rel, line=1,
                ident=module.dotted,
                message=f"{module.dotted} {what} but no "
                        "tests/test_torch_*.py imports it and defines a "
                        f"{markers} function"))
    return findings


class KernelParityRegistered(Rule):
    """Every module that builds a hand-written kernel — loads a
    ``csrc/*.cu`` source through ``kernels/_build.py``, or defines an
    ``@triton.jit`` function — must be imported by a test module that
    defines a ``test_*parity*`` or ``test_*plain_version*`` function.
    On the CPU a wrapper is its plain version, so only a test on the card
    holds the kernel itself against it: ``tests/test_torch_cuda.py``'s
    ``test_*_match(es)_plain_version`` tests, marked ``cuda``.  The
    counterpart of ``pallas-parity-registered``."""

    name = "kernel-parity-registered"
    scope = ()
    describe = ("every module building a CUDA or Triton kernel needs a "
                "registered test_*parity* or test_*plain_version* test")
    #: the probe must keep finding these modules, else it went stale
    expected_modules = ("raft_tpu_torch.kernels.gj_solve",
                        "raft_tpu_torch.kernels.fused_block",
                        "raft_tpu_torch.kernels.bem_gj")

    @staticmethod
    def _builds_kernel(module):
        # a source path: _build.CSRC joined with a literal "*.cu"
        csrc = cu = False
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Attribute) and node.attr == "CSRC" \
                    and isinstance(node.value, ast.Name) \
                    and module.import_aliases.get(
                        node.value.id, ".".join(module.from_imports.get(
                            node.value.id, ("", "")))) \
                    == "raft_tpu_torch.kernels._build":
                csrc = True
            elif isinstance(node, ast.Constant) and isinstance(
                    node.value, str) and node.value.endswith(".cu"):
                cu = True
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    base = dec.func if isinstance(dec, ast.Call) else dec
                    if isinstance(base, ast.Attribute) \
                            and base.attr == "jit" \
                            and isinstance(base.value, ast.Name) \
                            and base.value.id == "triton":
                        return True
        return csrc and cu

    def finalize(self, project):
        mods = [m for m in project.package_modules()
                if self._builds_kernel(m)]
        return _registered(project, self, mods, self.expected_modules,
                           ("parity", "plain_version"),
                           "builds a hand-written kernel")


class AutogradFunctionRegistered(Rule):
    """Every module defining a ``torch.autograd.Function`` subclass must
    be imported by a test module that defines a ``test_*grad*``
    function.  A hand-written backward replaces autograd: nothing in the
    forward pass breaks when it rots, so a gradient test is its only
    guard.  The counterpart of ``custom-vjp-registered``."""

    name = "autograd-function-registered"
    scope = ()
    describe = ("every module defining a torch.autograd.Function needs a "
                "registered test_*grad* test")
    expected_modules = ("raft_tpu_torch.mooring", "raft_tpu_torch.dynamics",
                        "raft_tpu_torch.grad.fixed_point")

    @staticmethod
    def _defines_function(module):
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for base in node.bases:
                if isinstance(base, ast.Attribute) \
                        and base.attr == "Function" \
                        and isinstance(base.value, (ast.Attribute,
                                                    ast.Name)) \
                        and (getattr(base.value, "attr", None)
                             or getattr(base.value, "id", None)) \
                        == "autograd":
                    return True
                if isinstance(base, ast.Name) and base.id == "Function" \
                        and module.from_imports.get("Function", ("",))[0] \
                        == "torch.autograd":
                    return True
        return False

    def finalize(self, project):
        mods = [m for m in project.package_modules()
                if self._defines_function(m)]
        return _registered(project, self, mods, self.expected_modules,
                           ("grad",), "defines a torch.autograd.Function")
