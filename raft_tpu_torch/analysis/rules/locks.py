"""lock-discipline: guarded-attribute writes vs declared locks — the
port's copy of ``raft_tpu/analysis/rules/locks.py``, scoped to the
port's serve and obs tiers.

Contracts are declared IN SOURCE, not in this rule: a class that owns
shared mutable state declares

    _GUARDED_BY = {"_queue": "_lock", "stats": "_lock", ...}

mapping attribute names to the lock attribute that guards them, and
optionally

    _LOCK_FREE = ("probe",)

naming methods that are *declared lock-free readers* (gauges).  The
rule then enforces, for every class in its scoped files:

* every write to a guarded attribute (``self.attr = ...``,
  ``self.attr[k] = ...``, ``self.attr += ...``, mutating method calls
  like ``self.attr.append(...)``) happens in a context that holds the
  owning lock: lexically inside ``with self.<lock>:`` (Condition
  attributes constructed over a lock count as aliases), in a method
  whose name ends ``_locked`` (the codebase's caller-holds-the-lock
  convention), or in ``__init__`` (construction happens-before
  publication);
* a ``_LOCK_FREE`` method never acquires any declared lock and never
  writes any ``self.*`` state — it must stay a pure gauge read;
* a class that constructs a ``threading.Lock``/``RLock`` but declares
  no ``_GUARDED_BY`` is flagged: the contract must be written down
  where this rule (and the next maintainer) can read it.

docs/robustness.md "Lock discipline" documents the convention, which the
port keeps.
"""

import ast

from raft_tpu_torch.analysis.core import Finding, Rule
from raft_tpu_torch.analysis.rules.legacy import qualname_of

LOCK_CTORS = {"Lock", "RLock"}
#: method names that mutate their receiver in place
MUTATORS = {"append", "extend", "insert", "update", "add", "pop",
            "popitem", "remove", "discard", "clear", "setdefault",
            "appendleft", "popleft", "write", "sort"}


def _self_attr(node):
    """'attr' when node is ``self.attr``, else None."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _self_attr_root(node):
    """The ``self.<attr>`` root of an attribute/subscript chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        attr = _self_attr(node)
        if attr is not None:
            return attr
        node = node.value
    return None


def _literal_str_dict(node):
    try:
        val = ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None
    if isinstance(val, dict) and all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in val.items()):
        return val
    return None


class _ClassModel:
    def __init__(self, cls_node):
        self.node = cls_node
        self.name = cls_node.name
        self.guarded = None           # {attr: lock} or None
        self.lock_free = ()
        self.lock_attrs = set()       # attrs holding Lock/RLock
        self.aliases = {}             # condition attr -> lock attr
        self._scan()

    def _scan(self):
        for stmt in self.node.body:
            if isinstance(stmt, ast.Assign):
                for target in stmt.targets:
                    if isinstance(target, ast.Name):
                        if target.id == "_GUARDED_BY":
                            self.guarded = _literal_str_dict(stmt.value)
                        elif target.id == "_LOCK_FREE":
                            try:
                                val = ast.literal_eval(stmt.value)
                                self.lock_free = tuple(val)
                            except (ValueError, SyntaxError):
                                pass
        for node in ast.walk(self.node):
            if not isinstance(node, ast.Assign):
                continue
            attr = None
            for target in node.targets:
                a = _self_attr(target)
                if a:
                    attr = a
            if attr is None or not isinstance(node.value, ast.Call):
                continue
            cname = node.value.func.attr \
                if isinstance(node.value.func, ast.Attribute) \
                else (node.value.func.id
                      if isinstance(node.value.func, ast.Name) else "")
            if cname in LOCK_CTORS:
                self.lock_attrs.add(attr)
            elif cname == "Condition" and node.value.args:
                base = _self_attr(node.value.args[0])
                if base:
                    self.aliases[attr] = base

    def locks_guarding(self, lock):
        """The lock attr + every Condition alias wrapping it."""
        names = {lock}
        names |= {cond for cond, base in self.aliases.items()
                  if base == lock}
        return names


class LockDiscipline(Rule):
    """See module docstring."""

    name = "lock-discipline"
    scope = ("raft_tpu_torch/serve/engine.py",
             "raft_tpu_torch/serve/router.py",
             "raft_tpu_torch/serve/autoscale.py",
             "raft_tpu_torch/serve/transport.py",
             "raft_tpu_torch/resilience.py",
             "raft_tpu_torch/obs/metrics.py",
             "raft_tpu_torch/obs/tracing.py",
             "raft_tpu_torch/obs/profiler.py")
    describe = ("writes to _GUARDED_BY attributes hold the owning "
                "lock; _LOCK_FREE readers never lock or write")

    def check(self, tree, source, path):
        findings = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(node, tree, path))
        return findings

    def _check_class(self, cls_node, tree, path):
        model = _ClassModel(cls_node)
        findings = []
        if model.guarded is None:
            if model.lock_attrs:
                findings.append(Finding(
                    rule=self.name, path=path, line=cls_node.lineno,
                    ident=f"{model.name}:undeclared",
                    message=f"class {model.name} constructs a lock "
                            f"({sorted(model.lock_attrs)}) but declares "
                            "no _GUARDED_BY map — write the contract "
                            "down (docs/robustness.md 'Lock "
                            "discipline')"))
            return findings
        methods = [n for n in cls_node.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]
        for method in methods:
            findings.extend(self._check_method(model, method, path))
        return findings

    def _locks_held(self, stack, model):
        held = set()
        for node in stack:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr:
                        held.add(model.aliases.get(attr, attr))
        return held

    def _check_method(self, model, method, path):
        findings = []
        in_init = method.name == "__init__"
        assumed = method.name.endswith("_locked")
        lock_free = method.name in model.lock_free

        def visit(node, stack):
            for child in ast.iter_child_nodes(node):
                self._check_node(model, method, child, stack, findings,
                                 path, in_init, assumed, lock_free)
                visit(child, stack + [child])

        visit(method, [method])
        return findings

    def _check_node(self, model, method, node, stack, findings, path,
                    in_init, assumed, lock_free):
        writes = []                       # (node, attr, verb)
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                attr = _self_attr_root(t)
                if attr:
                    writes.append((node, attr, "write to"))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            if node.func.attr in MUTATORS:
                attr = _self_attr_root(node.func.value)
                if attr:
                    writes.append((node, attr,
                                   f".{node.func.attr}() on"))
            elif node.func.attr == "acquire":
                attr = _self_attr(node.func.value)
                if attr and lock_free and (
                        attr in model.lock_attrs
                        or attr in model.aliases):
                    findings.append(Finding(
                        rule=self.name, path=path, line=node.lineno,
                        ident=f"{model.name}.{method.name}:acquires",
                        message=f"declared lock-free "
                                f"{model.name}.{method.name} acquires "
                                f"self.{attr}"))
        if isinstance(node, (ast.With, ast.AsyncWith)) and lock_free:
            for item in node.items:
                attr = _self_attr(item.context_expr)
                if attr and (attr in model.lock_attrs
                             or attr in model.aliases):
                    findings.append(Finding(
                        rule=self.name, path=path, line=node.lineno,
                        ident=f"{model.name}.{method.name}:acquires",
                        message=f"declared lock-free "
                                f"{model.name}.{method.name} takes "
                                f"`with self.{attr}:`"))
        if not writes:
            return
        held = self._locks_held(stack, model)
        for wnode, attr, verb in writes:
            if lock_free:
                findings.append(Finding(
                    rule=self.name, path=path, line=wnode.lineno,
                    ident=f"{model.name}.{method.name}:{attr}",
                    message=f"declared lock-free "
                            f"{model.name}.{method.name} {verb} "
                            f"self.{attr} — gauges must not write"))
                continue
            owner = model.guarded.get(attr)
            if owner is None:
                continue
            if in_init or assumed:
                continue
            if model.locks_guarding(owner) & held:
                continue
            findings.append(Finding(
                rule=self.name, path=path, line=wnode.lineno,
                ident=f"{model.name}.{method.name}:{attr}",
                message=f"{model.name}.{method.name} {verb} guarded "
                        f"self.{attr} without holding self.{owner} "
                        "(declared in _GUARDED_BY; hold the lock, or "
                        "suffix the method `_locked` if the caller "
                        "holds it)"))
