# Copied from blance_tpu/analysis/asyncio_lint.py.
"""asyncio-safety lint: the orchestrator's cancellation contracts.

The control plane (orchestrate/) is cooperative asyncio with Go-style
channels; its failure modes are quiet ones — a fire-and-forget task whose
exception nobody ever retrieves, a blocking call that stalls the whole
loop, a broad ``except`` that eats the very error that explained the
wedge, an un-deadlined await of app code (the cancelled-waiter bug class
the fault-tolerance work hardened csp.Chan against).  Rules:

- ASY101: fire-and-forget ``asyncio.ensure_future(...)`` /
  ``create_task(...)`` whose result is neither awaited, stored, nor
  passed on.  A dropped Task reference can be garbage-collected mid-run
  and its exception is never retrieved.
- ASY102: blocking host calls inside ``async def`` — ``time.sleep``,
  ``subprocess.*``, ``os.system``, ``socket.create_connection``,
  ``urllib.request.*``.  One blocking call stalls every mover on the
  loop.
- ASY103: silent broad exception swallow — an ``except Exception`` /
  ``except BaseException`` / bare ``except`` handler whose body neither
  re-raises, uses the caught exception, nor logs, just
  pass/return/continue or a constant assignment.  On pre-3.8-style
  asyncio paths (and for ``BaseException`` always) this also swallows
  ``CancelledError``; everywhere it buries the evidence.  Applies
  package-wide (sync code swallows just as silently).
- ASY104: ``await`` of an app-supplied callback result without an
  enclosing ``asyncio.wait_for`` deadline.  App code the orchestrator
  does not control must not be awaited open-endedly on a path that has
  no cancellation story.  Callback sources are recognized by attribute
  name (``_assign_partitions`` and friends — see _CALLBACK_ATTRS).

ASY101/102/104 only apply under ``async def``; ASY103 is package-wide.
"""

from __future__ import annotations

import ast
from typing import Optional

from . import Finding
from ._astutil import FindingEmitter as _FileLint, dotted as _dotted

__all__ = ["lint_file", "lint_source"]

_SPAWN_CALLS = {"ensure_future", "create_task"}

# Dotted-suffix blocklist for ASY102.
_BLOCKING = {
    "time.sleep": "blocks the event loop; use asyncio.sleep",
    "os.system": "blocks the event loop; use asyncio.create_subprocess_*",
    "subprocess.run": "blocks the event loop",
    "subprocess.call": "blocks the event loop",
    "subprocess.check_call": "blocks the event loop",
    "subprocess.check_output": "blocks the event loop",
    "socket.create_connection": "blocking connect on the event loop",
    "urllib.request.urlopen": "blocking I/O on the event loop",
    "requests.get": "blocking I/O on the event loop",
    "requests.post": "blocking I/O on the event loop",
}

# Attribute names that hold app-supplied callbacks (ASY104).  The
# orchestrator's data plane is exactly one attribute today; the list is
# the rule's configuration surface.
_CALLBACK_ATTRS = {"_assign_partitions", "assign_partitions"}


def _is_spawn_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func)
    if d is None:
        return False
    leaf = d.split(".")[-1]
    return leaf in _SPAWN_CALLS


class _AsyncRules(ast.NodeVisitor):
    """ASY101/102/104 inside one async function body."""

    def __init__(self, lint: "_FileLint", func: ast.AsyncFunctionDef,
                 qualname: str) -> None:
        self.lint = lint
        self.func = func
        self.qualname = qualname
        # Names holding values produced by a callback attribute call:
        # result = self._assign_partitions(...)
        self.callback_values: set[str] = set()

    def run(self) -> None:
        for stmt in self.func.body:
            self._visit_stmt(stmt)

    # Walk statements manually so nested function defs don't leak in.
    def _visit_stmt(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs are linted as their own functions
        if isinstance(node, ast.Expr):
            self._check_expr_stmt(node)
        if isinstance(node, ast.Assign):
            self._track_callback_assign(node)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._visit_stmt(child)
            else:
                self._visit_expr_tree(child)

    def _visit_expr_tree(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._check_blocking(sub)
            elif isinstance(sub, ast.Await):
                self._check_await(sub)

    def _check_expr_stmt(self, node: ast.Expr) -> None:
        # ASY101: a spawn call as a bare expression statement.
        if _is_spawn_call(node.value):
            self.lint.emit(
                "ASY101", node.lineno, self.qualname,
                "fire-and-forget task: the returned Task is neither "
                "awaited nor stored — it can be garbage-collected "
                "mid-run and its exception is never retrieved; keep a "
                "reference and observe it (add_done_callback or await)")

    def _track_callback_assign(self, node: ast.Assign) -> None:
        val = node.value
        if isinstance(val, ast.Call):
            d = _dotted(val.func)
            if d is not None and d.split(".")[-1] in _CALLBACK_ATTRS:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.callback_values.add(t.id)

    def _check_blocking(self, node: ast.Call) -> None:
        d = _dotted(node.func)
        if d is None:
            return
        for pattern, why in _BLOCKING.items():
            if d == pattern or d.endswith("." + pattern):
                self.lint.emit(
                    "ASY102", node.lineno, self.qualname,
                    f"blocking call {pattern} inside async def: {why}")
                return

    def _check_await(self, node: ast.Await) -> None:
        # ASY104: awaiting an app callback value with no wait_for.
        val = node.value
        if isinstance(val, ast.Call):
            d = _dotted(val.func)
            if d is not None and d.split(".")[-1] in _CALLBACK_ATTRS:
                self._emit_104(node)
                return
            # await asyncio.wait_for(cb(...), t) is the sanctioned shape.
            return
        if isinstance(val, ast.Name) and val.id in self.callback_values:
            if not self._under_wait_for(node):
                self._emit_104(node)

    def _under_wait_for(self, node: ast.Await) -> bool:
        # The sanctioned spelling wraps the awaitable in wait_for INSIDE
        # the await expression; an `await x` of a raw callback value is
        # by definition not deadlined.
        if isinstance(node.value, ast.Call):
            d = _dotted(node.value.func)
            return d is not None and d.split(".")[-1] == "wait_for"
        return False

    def _emit_104(self, node: ast.Await) -> None:
        self.lint.emit(
            "ASY104", node.lineno, self.qualname,
            "await of an app-supplied callback without an "
            "asyncio.wait_for deadline: app code the orchestrator does "
            "not control is awaited open-endedly (no cancellation "
            "story); wrap in wait_for or document the legacy-mode "
            "contract in the baseline")


def _handler_is_silent(handler: ast.ExceptHandler) -> bool:
    """True when a handler neither re-raises, uses the exception, nor
    plausibly logs: body is only pass/continue/break, constant returns,
    or constant-valued assignments."""
    name = handler.name
    for stmt in handler.body:
        if isinstance(stmt, ast.Raise):
            return False
        # Any reference to the bound exception name counts as "used".
        if name is not None:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Name) and sub.id == name:
                    return False
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Return):
            if stmt.value is None or isinstance(stmt.value, ast.Constant):
                continue
            return False
        if isinstance(stmt, ast.Assign) and \
                isinstance(stmt.value, ast.Constant):
            continue
        # Calls (logging, counters), raises, anything else: not silent.
        return False
    return True


def _broad_except_type(handler: ast.ExceptHandler) -> Optional[str]:
    if handler.type is None:
        return "bare except"
    d = _dotted(handler.type)
    if d in ("Exception", "BaseException"):
        return f"except {d}"
    return None


def lint_source(src: str, path: str,
                repo_root: str) -> list[Finding]:
    lint = _FileLint(path, repo_root)
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        lint.emit("ASY100", e.lineno or 0, "",
                  f"file does not parse: {e.msg}")
        return lint.findings

    # Function table with qualnames, so findings anchor to symbols.
    def walk_funcs(body, prefix):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{node.name}"
                yield qn, node
                yield from walk_funcs(node.body, f"{qn}.")
            elif isinstance(node, ast.ClassDef):
                yield from walk_funcs(node.body, f"{prefix}{node.name}.")

    funcs = list(walk_funcs(tree.body, ""))

    # ASY101/102/104: async functions only.
    for qn, fn in funcs:
        if isinstance(fn, ast.AsyncFunctionDef):
            _AsyncRules(lint, fn, qn).run()

    # ASY103: silent broad swallows, package-wide.  Anchored to the
    # enclosing function (or module level).
    def enclosing(lineno: int) -> str:
        best = ""
        best_line = -1
        for qn, fn in funcs:
            if fn.lineno <= lineno and fn.lineno > best_line:
                end = getattr(fn, "end_lineno", None)
                if end is None or lineno <= end:
                    best, best_line = qn, fn.lineno
        return best

    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        for handler in node.handlers:
            broad = _broad_except_type(handler)
            if broad is None or not _handler_is_silent(handler):
                continue
            lint.emit(
                "ASY103", handler.lineno, enclosing(handler.lineno),
                f"silent {broad}: swallows every failure (incl. "
                f"CancelledError for bare/BaseException) with no "
                f"re-raise, no use of the exception, no logging — "
                f"narrow it to the concrete types this path actually "
                f"guards and surface the rest")
    return lint.findings


def lint_file(path: str, repo_root: str) -> list[Finding]:
    with open(path) as f:
        return lint_source(f.read(), path, repo_root)
