"""The parsed view of the port that every rule reads — the parts of
``raft_tpu/analysis/project.py`` the port's rules need, scoped to the
port: the package ``raft_tpu_torch``, its tests ``tests/test_torch_*.py``
and ``chip_smoke.py``.

One parse feeds every rule: the module list (path, source, AST, dotted
name, import aliases) and every read of one of the JAX package's
environment flags (named after it: its name upper-cased, then ``_``).
The model is pure ``ast`` + ``os``: building it never imports the code
under analysis, so it runs the same with or without torch, and on the
card's machine, which has no jax.
"""

import ast
import fnmatch
import os
from dataclasses import dataclass, field

PACKAGE = "raft_tpu_torch"
#: the files the port's rules see (repo-relative globs)
SCOPE = (PACKAGE + "/*.py", PACKAGE + "/**/*.py", "tests/test_torch_*.py",
         "chip_smoke.py")
SKIP_DIRS = {"__pycache__", ".pytest_cache"}

JAX_PACKAGE = "raft_tpu"
#: the JAX package's environment flags all start with this
ENV_PREFIX = JAX_PACKAGE.upper() + "_"


def callee_name(call):
    """Bare (rightmost) name of a call's callee, or ''."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


@dataclass
class EnvReadSite:
    """One ``os.environ``/``os.getenv`` read of a JAX-package flag."""

    rel: str
    lineno: int
    var: str
    module: str or None = None


@dataclass
class ModuleInfo:
    """One parsed source file."""

    path: str
    rel: str
    source: str
    tree: object
    dotted: str or None               # raft_tpu_torch.foo for package files

    import_aliases: dict = field(default_factory=dict)   # name -> module
    from_imports: dict = field(default_factory=dict)     # name -> (mod, orig)

    def _index(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.import_aliases[alias.asname or
                                        alias.name.split(".")[0]] = \
                        alias.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self.from_imports[alias.asname or alias.name] = \
                        (node.module, alias.name)


class ProjectModel:
    """Parsed view of the port's files (see module docstring)."""

    def __init__(self, root, package=PACKAGE):
        self.root = os.path.abspath(root)
        self.package = package
        self.modules = {}              # rel -> ModuleInfo
        self._load()
        self._env_sites = None

    def _iter_py_files(self):
        tops = sorted({pat.split("/")[0] for pat in SCOPE if "/" in pat})
        paths = [os.path.join(self.root, name) for name in sorted(
            os.listdir(self.root)) if name.endswith(".py")]
        for top in tops:
            for dirpath, dirnames, filenames in os.walk(
                    os.path.join(self.root, top)):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in SKIP_DIRS)
                paths += [os.path.join(dirpath, name)
                          for name in sorted(filenames)]
        for path in paths:
            rel = os.path.relpath(path, self.root).replace(os.sep, "/")
            if any(fnmatch.fnmatch(rel, pat) for pat in SCOPE):
                yield path, rel

    def _load(self):
        for path, rel in self._iter_py_files():
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
            try:
                tree = ast.parse(source, filename=rel)
            except SyntaxError:
                tree = ast.parse("")
            dotted = None
            if rel.startswith(self.package + "/"):
                dotted = rel[:-3].replace("/", ".")
                if dotted.endswith(".__init__"):
                    dotted = dotted[:-len(".__init__")]
            info = ModuleInfo(path=path, rel=rel, source=source, tree=tree,
                              dotted=dotted)
            info._index()
            self.modules[rel] = info

    def package_modules(self):
        return [m for m in self.modules.values() if m.dotted]

    def module_by_dotted(self, dotted):
        for m in self.modules.values():
            if m.dotted == dotted:
                return m
        return None

    def test_modules(self):
        return [m for m in self.modules.values()
                if m.rel.startswith("tests/")]

    def read_text(self, relpath):
        """A non-Python project file (docs, allowlists), or None."""
        path = os.path.join(self.root, relpath)
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as fh:
            return fh.read()

    def _env_name(self, module, node):
        """The name of a module-alias reference, e.g. ``_os`` -> ``os``."""
        if isinstance(node, ast.Name):
            return module.import_aliases.get(node.id) or \
                (".".join(module.from_imports[node.id])
                 if node.id in module.from_imports else node.id)
        if isinstance(node, ast.Attribute):
            base = self._env_name(module, node.value)
            return f"{base}.{node.attr}" if base else node.attr
        return None

    def env_read_sites(self):
        """Every literal read of a JAX-package flag (``ENV_PREFIX``) in
        the scoped files."""
        if self._env_sites is not None:
            return self._env_sites
        sites = []
        for module in self.modules.values():
            for node in ast.walk(module.tree):
                var = None
                if isinstance(node, ast.Call):
                    target = self._env_name(module, node.func)
                    if target in ("os.environ.get", "os.getenv",
                                  "environ.get", "os.environ.setdefault",
                                  "environ.setdefault"):
                        if node.args and isinstance(node.args[0],
                                                    ast.Constant) \
                                and isinstance(node.args[0].value, str):
                            var = node.args[0].value
                elif isinstance(node, ast.Subscript):
                    target = self._env_name(module, node.value)
                    if target in ("os.environ", "environ") \
                            and isinstance(node.slice, ast.Constant) \
                            and isinstance(node.slice.value, str):
                        var = node.slice.value
                if var and var.startswith(ENV_PREFIX):
                    sites.append(EnvReadSite(
                        rel=module.rel, lineno=node.lineno, var=var,
                        module=module.dotted))
        self._env_sites = sites
        return sites
