"""The port's own rules: ``port-independence`` and ``no-env-flags``.

``port-independence`` — no module of ``raft_tpu_torch`` and not
``chip_smoke.py`` imports ``jax``, ``jaxlib`` or the JAX package
``raft_tpu``, at any depth (inside functions too), by an import
statement or by ``importlib.import_module`` / ``__import__`` with a
literal name.  Only the tests import both packages.

``no-env-flags`` — the port's form of the JAX package's ``flag-hygiene``:
every knob is an argument, so

1. no scoped file reads ``os.environ`` / ``os.getenv`` for one of the
   JAX package's flags (a name starting with ``project.ENV_PREFIX``);
2. every key of ``serve/cache.py``'s ``FLAG_SURFACE`` (what ``GET
   /versionz`` reports) is a key ``current_flags()`` produces — the
   stale-row check.

There is no counterpart of ``traced-purity``: the port uses no
``torch.func`` transform, ``torch.compile`` or CUDA-graph capture of its
library code, so no host work hides inside a trace.
"""

import ast

from raft_tpu_torch.analysis.core import Finding, Rule
from raft_tpu_torch.analysis.project import JAX_PACKAGE, callee_name

FORBIDDEN = ("jax", "jaxlib", JAX_PACKAGE)
CACHE = "raft_tpu_torch/serve/cache.py"


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


class PortIndependence(Rule):
    """See module docstring."""

    name = "port-independence"
    scope = ("raft_tpu_torch/*.py", "chip_smoke.py")
    describe = ("no module of raft_tpu_torch and not chip_smoke.py "
                "imports jax, jaxlib or raft_tpu")

    def check(self, tree, source, path):
        findings = []
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module:
                names = [node.module]
            elif isinstance(node, ast.Call) and callee_name(node) in (
                    "import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                names = [node.args[0].value]
            for name in names:
                if _forbidden(name):
                    findings.append(Finding(
                        rule=self.name, path=path, line=node.lineno,
                        ident=f"import:{name}",
                        message=f"imports {name}: the port runs without "
                                "jax and imports nothing of raft_tpu "
                                "(keep a copy of what it needs)"))
        return findings


def _literal(tree, name, env):
    """The literal value assigned to module-level ``name``: tuples of
    string constants, and ``+`` of names already resolved in ``env``."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return _eval(node.value, env)
    return None


def _eval(node, env):
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _eval(node.left, env), _eval(node.right, env)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.Name):
        return env.get(node.id)
    try:
        return ast.literal_eval(node)
    except ValueError:
        return None


def _dict_keys(node):
    return {k.value for k in node.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)}


def _function(tree, name):
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def produced_flags(tree):
    """The keys ``current_flags()`` produces: the dict literals bound in
    it, and those of every dict literal returned by a module function
    whose result it merges in (``flags.update(topology_flags(...))``)."""
    fn = _function(tree, "current_flags")
    if fn is None:
        return None
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Dict):
            keys |= _dict_keys(node.value)
        elif isinstance(node, ast.Call) and callee_name(node) == "update":
            for arg in node.args:
                if isinstance(arg, ast.Dict):
                    keys |= _dict_keys(arg)
                elif isinstance(arg, ast.Call):
                    helper = _function(tree, callee_name(arg))
                    for sub in ast.walk(helper) if helper else ():
                        if isinstance(sub, ast.Return) \
                                and isinstance(sub.value, ast.Dict):
                            keys |= _dict_keys(sub.value)
        elif isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Store) and isinstance(node.slice,
                                                    ast.Constant):
            keys.add(node.slice.value)
    return keys


class NoEnvFlags(Rule):
    """See module docstring."""

    name = "no-env-flags"
    scope = ()
    describe = ("no reads of the JAX package's environment flags in the "
                "port; every FLAG_SURFACE key is one current_flags() "
                "produces")

    def finalize(self, project):
        findings = []
        for site in project.env_read_sites():
            findings.append(Finding(
                rule=self.name, path=site.rel, line=site.lineno,
                ident=site.var,
                message=f"reads {site.var} from the environment: the "
                        "port takes every knob as an argument or flag"))
        cache = project.modules.get(CACHE)
        if cache is None:
            return findings + [Finding(
                rule=self.name, path=CACHE, line=1, ident="missing-cache",
                message=f"{CACHE} not found — the flag-surface check has "
                        "no contract to read")]
        env = {}
        for node in cache.tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        val = _eval(node.value, env)
                        if val is not None:
                            env[t.id] = val
        surface = env.get("FLAG_SURFACE")
        produced = produced_flags(cache.tree)
        if not isinstance(surface, tuple) or produced is None:
            return findings + [Finding(
                rule=self.name, path=CACHE, line=1,
                ident="stale-probe:FLAG_SURFACE",
                message=f"{CACHE} no longer assigns a literal "
                        "FLAG_SURFACE tuple or defines current_flags(); "
                        "update this rule's probe")]
        for key in surface:
            if key not in produced:
                findings.append(Finding(
                    rule=self.name, path=CACHE, line=1,
                    ident=f"{key}:surface-stale",
                    message=f"FLAG_SURFACE lists {key!r}, which "
                            "current_flags() never produces — stale row"))
        return findings
