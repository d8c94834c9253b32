# Copied from blance_tpu/analysis/_astutil.py.
"""AST helpers shared by the analysis passes.

One copy of the dotted-path resolver, the per-file Finding emitter and —
since the determinism pass joined jit-purity in needing a
cross-module call graph — the whole-program :class:`ModuleIndex`:
module/function indexing, import and re-export resolution, and the
reachability walk.  Two diverging copies of the import resolver is how a
relative-import fix silently misses a pass.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Optional

from . import Finding

__all__ = ["dotted", "FindingEmitter", "FuncInfo", "ModuleInfo",
           "ModuleIndex", "module_name"]


def dotted(node: ast.AST) -> Optional[str]:
    """Attribute/Name chain -> "a.b.c", else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class FindingEmitter:
    """Collects findings for one file, anchored to its repo-relative
    forward-slash path."""

    def __init__(self, path: str, repo_root: str) -> None:
        self.rel = os.path.relpath(
            os.path.abspath(path), repo_root).replace(os.sep, "/")
        self.findings: list[Finding] = []

    def emit(self, rule: str, line: int, symbol: str, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.rel, line=line, symbol=symbol,
            message=message))


@dataclass
class FuncInfo:
    module: str  # dotted module name
    qualname: str  # "fn" or "Class.method"
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    path: str  # repo-relative file path
    params: list[str] = field(default_factory=list)
    # Params with literal defaults: when such a function becomes a trace
    # root through shard_map/partial wrapping (no static_argnames to
    # consult), branching on them is almost always the benign
    # Python-default pattern — exempt from JIT002/JIT003.
    defaulted: set[str] = field(default_factory=set)
    is_root: bool = False
    statics: set[str] = field(default_factory=set)  # declared static argnames

    @property
    def fq(self) -> str:
        return f"{self.module}.{self.qualname}"


@dataclass
class ModuleInfo:
    name: str  # dotted
    path: str  # repo-relative
    tree: ast.Module
    is_pkg: bool = False  # an __init__.py (relative imports resolve
    # against the package itself, not its parent)
    imports: dict[str, str] = field(default_factory=dict)
    functions: dict[str, "FuncInfo"] = field(default_factory=dict)
    constants: dict[str, object] = field(default_factory=dict)


def module_name(path: str, repo_root: str) -> str:
    rel = os.path.relpath(os.path.abspath(path), repo_root)
    rel = rel[:-3] if rel.endswith(".py") else rel
    parts = rel.replace(os.sep, "/").split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class ModuleIndex:
    """Whole-program module/function index with import resolution and a
    reachability walk.  Files that do not parse land in
    :attr:`parse_errors` for the owning pass to report under its own
    rule code."""

    def __init__(self, files: list[str], repo_root: str) -> None:
        self.repo_root = repo_root
        self.modules: dict[str, ModuleInfo] = {}
        # (repo-relative path, line, message) per unparseable file.
        self.parse_errors: list[tuple[str, int, str]] = []
        for path in files:
            rel = os.path.relpath(
                os.path.abspath(path), repo_root).replace(os.sep, "/")
            try:
                with open(path) as f:
                    src = f.read()
                tree = ast.parse(src, filename=path)
            except SyntaxError as e:
                self.parse_errors.append((rel, e.lineno or 0, e.msg or ""))
                continue
            mi = ModuleInfo(name=module_name(path, repo_root), path=rel,
                            tree=tree, is_pkg=rel.endswith("__init__.py"))
            self._index_module(mi)
            self.modules[mi.name] = mi

    # -- indexing -----------------------------------------------------------

    def _index_module(self, mi: ModuleInfo) -> None:
        for node in mi.tree.body:
            self._index_stmt(mi, node, prefix="")

    def _index_stmt(self, mi: ModuleInfo, node: ast.stmt,
                    prefix: str) -> None:
        if isinstance(node, ast.Import):
            for alias in node.names:
                mi.imports[alias.asname or alias.name.split(".")[0]] = \
                    alias.name if alias.asname else \
                    alias.name.split(".")[0]
                if alias.asname:
                    mi.imports[alias.asname] = alias.name
        elif isinstance(node, ast.ImportFrom):
            base = self._resolve_from(mi, node)
            for alias in node.names:
                if alias.name == "*":
                    continue
                mi.imports[alias.asname or alias.name] = \
                    f"{base}.{alias.name}" if base else alias.name
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qn = f"{prefix}{node.name}"
            args = node.args
            params = ([a.arg for a in args.posonlyargs]
                      + [a.arg for a in args.args]
                      + [a.arg for a in args.kwonlyargs])
            if args.vararg:
                params.append(args.vararg.arg)
            if args.kwarg:
                params.append(args.kwarg.arg)
            defaulted: set[str] = set()
            pos = [a.arg for a in args.posonlyargs] + \
                [a.arg for a in args.args]
            for name_, default in zip(pos[len(pos) - len(args.defaults):],
                                      args.defaults):
                if isinstance(default, ast.Constant):
                    defaulted.add(name_)
            for a, default in zip(args.kwonlyargs, args.kw_defaults):
                if isinstance(default, ast.Constant):
                    defaulted.add(a.arg)
            mi.functions[qn] = FuncInfo(
                module=mi.name, qualname=qn, node=node, path=mi.path,
                params=params, defaulted=defaulted)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                self._index_stmt(mi, sub, prefix=f"{node.name}.")
        elif isinstance(node, ast.Assign) and not prefix:
            # Module-level literal constants (for static_argnames=NAME).
            if len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                try:
                    mi.constants[node.targets[0].id] = \
                        ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    pass

    def _resolve_from(self, mi: ModuleInfo, node: ast.ImportFrom) -> str:
        if not node.level:
            return node.module or ""
        parts = mi.name.split(".")
        # level=1 is the CURRENT package: for a module that is its
        # parent (drop the module's own name); for an __init__.py the
        # module name IS the package.  Each extra level pops one more.
        base = parts if mi.is_pkg else parts[:-1]
        extra = node.level - 1
        base = base[:len(base) - extra] if extra else base
        if node.module:
            base = base + node.module.split(".")
        return ".".join(base)

    # -- symbol resolution --------------------------------------------------

    def resolve(self, mi: ModuleInfo, dotted_ref: str) -> str:
        """Map a dotted local reference to its fully-qualified spelling."""
        head, _, rest = dotted_ref.partition(".")
        fq_head = mi.imports.get(head, head)
        return f"{fq_head}.{rest}" if rest else fq_head

    def lookup_function(self, mi: ModuleInfo,
                        dotted_ref: str) -> Optional[FuncInfo]:
        """Resolve a reference to a FuncInfo in the analyzed set."""
        # Same-module bare name (incl. Class.method chains).
        if dotted_ref in mi.functions:
            return mi.functions[dotted_ref]
        return self.lookup_fq(self.resolve(mi, dotted_ref))

    def lookup_fq(self, fq: str, depth: int = 0) -> Optional[FuncInfo]:
        """Find a FuncInfo by fully-qualified name, chasing package
        re-exports: ``pkg.helper`` where pkg/__init__.py does ``from
        .impl import helper`` resolves to ``pkg.impl.helper`` — the
        idiom this codebase uses for its public surfaces, which the
        call graph must see through (depth-bounded: a re-export cycle
        must not hang the lint)."""
        if depth > 8:
            return None
        # fq = "pkg.module.func" or "pkg.module.Class.func".
        parts = fq.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:cut])
            rest = ".".join(parts[cut:])
            target = self.modules.get(mod)
            if target is None:
                continue
            if rest in target.functions:
                return target.functions[rest]
            # Re-export chase: the symbol's head may be imported into
            # ``mod`` from somewhere else in the analyzed set.
            head, _, tail = rest.partition(".")
            if head in target.imports:
                re_fq = target.imports[head] + ("." + tail if tail else "")
                found = self.lookup_fq(re_fq, depth + 1)
                if found is not None:
                    return found
        return None

    def partial_target(self, mi: ModuleInfo,
                       call: ast.Call) -> Optional[FuncInfo]:
        """partial(f, ...) -> FuncInfo for f (one level)."""
        ref = dotted(call.func)
        if ref is None:
            return None
        if self.resolve(mi, ref) != "functools.partial":
            return None
        if not call.args:
            return None
        inner = dotted(call.args[0])
        if inner is None:
            return None
        return self.lookup_function(mi, inner)

    # -- reachability -------------------------------------------------------

    def reachable(self, roots: list[FuncInfo], *,
                  self_edges: bool = False) -> list[FuncInfo]:
        """BFS over call / function-reference edges from ``roots``.

        Edges: direct calls (dotted references, resolved through
        imports and re-exports), one level of ``partial(f, ...)``, and
        bare-name function references (callback registration).  With
        ``self_edges=True`` a ``self.method(...)`` call also reaches
        ``Class.method`` in the same module — the determinism pass
        needs method-level flow the jit graph deliberately skips
        (trace roots are free functions)."""
        seen = {fn.fq for fn in roots}
        queue = list(roots)
        while queue:
            fn = queue.pop()
            mi = self.modules[fn.module]
            for node in ast.walk(fn.node):
                ref = None
                if isinstance(node, ast.Call):
                    ref = dotted(node.func)
                    inner = self.partial_target(mi, node) \
                        if ref and self.resolve(mi, ref) == \
                        "functools.partial" else None
                    if inner is not None and inner.fq not in seen:
                        seen.add(inner.fq)
                        queue.append(inner)
                elif isinstance(node, ast.Name) and \
                        isinstance(node.ctx, ast.Load):
                    ref = node.id
                if ref is None:
                    continue
                callee = self.lookup_function(mi, ref)
                if callee is None and self_edges and \
                        ref.startswith("self.") and "." in fn.qualname:
                    cls = fn.qualname.split(".")[0]
                    callee = mi.functions.get(
                        f"{cls}.{ref[len('self.'):]}")
                if callee is not None and callee.fq not in seen:
                    seen.add(callee.fq)
                    queue.append(callee)
        return [self.by_fq(fq) for fq in sorted(seen)]

    def by_fq(self, fq: str) -> FuncInfo:
        for mi in self.modules.values():
            for fn in mi.functions.values():
                if fn.fq == fq:
                    return fn
        raise KeyError(fq)
