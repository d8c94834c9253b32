# Port of blance_tpu/analysis/donation.py: torch has no donation, so the
# registry is the declared CONSUMING table (the warm carry's single-use
# contract) and the rules keep their meaning over it; the liveness walk
# is the reference's.
"""Consumption lint: use-after-consume detection for the warm carry (DON00x).

The reference donates the warm carry table (and ``prev``) into its jitted
repair programs, and lints every read of a donated operand after its
dispatch.  torch has no donation, but the port keeps the reference's
single-use contract for the warm carry: ``plan/carry.py``'s
``CarryCache.consume`` says the carry is CONSUMED either way, and
``plan/tensor.py``'s ``solve_dense_warm`` says it is single-use by
contract.  A caller that reads the carry after handing it to a repair
works today and breaks the day the repair reuses the buffer in place, so
the contract is linted exactly as the reference lints donation.

The registry is a declared table, :data:`CONSUMING`: each port callable
with the parameters it consumes by contract.  The pass builds the shared
:class:`._astutil.ModuleIndex`, resolves each row to the callable's
signature (plus plain module-level aliases of it), then runs the
reference's linear execution-order liveness walk over every function
(nested defs are fresh scopes), tracking value identity through rebinds
(generation counters), zero-copy aliases (``torch.as_tensor``,
``torch.asarray``, ``torch.from_numpy``, ``x.to(...)``,
``x.contiguous()``), tuple packing for ``*args`` splats, and attribute
roots (``self.current``, ``carry.used``).

Rules (the reference's, over the table):

- **DON001** read of a consumed operand after its consuming call —
  including reads through aliases, attribute roots, packed argument
  tuples, and values returned so callers can re-read them (the
  reference's use-after-donation bug shape).
- **DON002** a consumed operand escapes before the call — stored to
  ``self.*``/an outer container or handed to a ``self.*`` store method
  (the CarryCache/EncodeCache risk surface).
- **DON003** the same value passed to a consuming callable twice
  without rebinding.
- **DON004** host snapshot (``np.asarray`` / ``.copy()`` / ``.clone()``)
  of a consumed operand AFTER its consuming call.  The same snapshot
  BEFORE the call is the sanctioned recipe and produces a fresh value,
  exempt from every rule.
- **DON000** file does not parse (the shared parse-error funnel).

Metadata reads (``.shape``, ``.dtype``, ``.device``, ...) stay legal
after the call.  Findings fold through ``analysis/baseline.toml``
exactly like the other rules; the package itself carries zero.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Optional, Sequence

from . import Finding
from ._astutil import FuncInfo, ModuleIndex, ModuleInfo
from ._astutil import dotted as _dotted

__all__ = ["DonationPass", "ConsumingCallable", "CONSUMING"]

# A value identity: a root key (("name", "used") / ("attr", "carry.used"))
# plus a rebind generation — rebinding bumps the generation, so a consumed
# vid never matches the freshly bound value under the same name.
_Key = tuple[str, str]
_Vid = tuple[_Key, int]

#: The consumption contract: port callable -> the parameters it consumes.
#: ``prev`` is in no row: the reference donates it into its repair and
#: pipeline programs, but the port deliberately re-reads it after the
#: solve (the uploaded ``prev`` tensor is the move diff's beginning state,
#: plan/tensor.py's fused-pipeline note), so it stays live by design.  The
#: reference's cold pipelines donate only ``prev`` and so have no row.
CONSUMING: dict[str, tuple[str, ...]] = {
    # the reference's _warm_repair_donating (prev, carry_used)
    "blance_tpu_torch.plan.tensor._warm_repair": ("carry_used",),
    # the reference's _warm_repair_sparse_donating (prev, carry_used)
    "blance_tpu_torch.plan.tensor._warm_repair_sparse": ("carry_used",),
    # the reference's _pipeline_warm_donating (prev, carry_used)
    "blance_tpu_torch.plan.tensor._pipeline_warm_impl": ("carry_used",),
    # the public warm solves: "the carry is single-use by contract"
    "blance_tpu_torch.plan.tensor.solve_dense_warm": ("carry",),
    "blance_tpu_torch.plan.tensor.solve_sparse_warm": ("carry",),
    # the sharded warm paths: "the carry is consumed either way", as the
    # reference's solve_dense_sharded says of its warm attempt
    "blance_tpu_torch.parallel.sharded.solve_dense_sharded": ("carry",),
    "blance_tpu_torch.parallel.sharded.solve_sparse_sharded": ("carry",),
    "blance_tpu_torch.parallel.sharded.solve_pipeline_sharded": ("carry",),
}

#: Zero-copy aliases: the result shares the operand's storage when it is
#: already a tensor on the target device, so consuming the result
#: consumes the operand.
_ALIAS_FQS = frozenset({
    "torch.as_tensor",
    "torch.asarray",
    "torch.from_numpy",
})

#: Methods whose result aliases the receiver when nothing has to move.
_ALIAS_METHODS = frozenset({"to", "contiguous"})

#: Host snapshots: the result is a fresh copy, never aliased.
_SNAPSHOT_FQS = frozenset({
    "numpy.asarray",
    "numpy.array",
    "numpy.ascontiguousarray",
    "numpy.copy",
    "torch.clone",
})

#: Methods that snapshot their receiver.
_SNAPSHOT_METHODS = frozenset({"copy", "clone"})

#: Attribute reads that stay legal after the call: a tensor's metadata
#: outlives any reuse of its storage.
_METADATA_ATTRS = frozenset({
    "shape", "dtype", "ndim", "size", "nbytes", "itemsize", "device",
    "dim", "numel", "is_cuda", "layout",
})

#: Store methods on ``self.*`` receivers that publish a reference to a
#: longer-lived container (the CarryCache/EncodeCache surface).
_ESCAPE_METHODS = frozenset({
    "store", "store_pending", "promote", "append", "add", "put",
    "update", "setdefault", "push", "cache",
})


@dataclass(frozen=True)
class ConsumingCallable:
    """One CONSUMING row resolved against the analyzed sources."""

    fq: str  # fully-qualified name the call sites call
    params: tuple[str, ...]  # the callable's full parameter order
    consumed: tuple[str, ...]  # consumed parameter names


class DonationPass:
    """Whole-program pass: index, resolve the CONSUMING rows, run the
    liveness walk over every function body.

    ``consuming`` exists for the fixture tests — the real CLI always
    runs the module-level table."""

    def __init__(self, files: list[str], repo_root: str, *,
                 consuming: Optional[dict[str, tuple[str, ...]]] = None
                 ) -> None:
        self.index = ModuleIndex(files, repo_root)
        self.consuming = CONSUMING if consuming is None else consuming
        self.findings: list[Finding] = []
        self.registry: dict[str, ConsumingCallable] = {}
        for rel, line, msg in self.index.parse_errors:
            self.findings.append(Finding(
                rule="DON000", path=rel, line=line, symbol="",
                message=f"file does not parse: {msg}"))

    # -- the registry -------------------------------------------------------

    def _build_registry(self) -> None:
        for fq, consumed in self.consuming.items():
            fn = self.index.lookup_fq(fq)
            if fn is None:
                continue  # not in the analyzed set
            self.registry[fn.fq] = ConsumingCallable(
                fq=fn.fq, params=tuple(fn.params),
                consumed=tuple(p for p in consumed if p in fn.params))
        # Plain aliases of consuming callables (one propagation round:
        # ``impl = _warm_repair`` at module level).
        for mi in self.index.modules.values():
            for node in ast.walk(mi.tree):
                if not (isinstance(node, ast.Assign) and
                        len(node.targets) == 1 and
                        isinstance(node.targets[0], ast.Name)):
                    continue
                d = _dotted(node.value)
                if d is None:
                    continue
                dc = self._registry_lookup(mi, d)
                if dc is not None:
                    self.registry.setdefault(
                        f"{mi.name}.{node.targets[0].id}", dc)

    def _registry_lookup(self, mi: ModuleInfo,
                         dotted_ref: str) -> Optional[ConsumingCallable]:
        local = f"{mi.name}.{dotted_ref}"
        if local in self.registry:
            return self.registry[local]
        fq = self.index.resolve(mi, dotted_ref)
        if fq in self.registry:
            return self.registry[fq]
        fn = self.index.lookup_function(mi, dotted_ref)
        return self.registry.get(fn.fq) if fn is not None else None

    # -- the run ------------------------------------------------------------

    def run(self) -> list[Finding]:
        self._build_registry()
        for mi in self.index.modules.values():
            for fn in mi.functions.values():
                node = fn.node
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    self._lint_body(mi, fn.path, fn.qualname, node.body)
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return self.findings

    def _lint_body(self, mi: ModuleInfo, path: str, symbol: str,
                   body: list[ast.stmt]) -> None:
        _ScopeLinter(self, mi, path, symbol).run(body)


def _walk_no_nested(nodes: Sequence[ast.AST]) -> list[ast.AST]:
    """All nodes under ``nodes`` except nested function/class bodies
    (those are linted as their own scopes)."""
    out: list[ast.AST] = []
    stack: list[ast.AST] = list(nodes)
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return out


class _ScopeLinter:
    """Linear execution-order liveness walk over one function body.

    Path-insensitive: branches are walked in source order and their
    effects accumulate — sound for the warm paths this pass guards,
    whose consuming call happens exactly once per scope, and
    conservative everywhere else (a read in EITHER branch after a
    call in EITHER branch is flagged)."""

    def __init__(self, owner: DonationPass, mi: ModuleInfo, path: str,
                 symbol: str) -> None:
        self.owner = owner
        self.mi = mi
        self.path = path
        self.symbol = symbol
        self.gen: dict[_Key, int] = {}
        # name -> vid of the value it aliases (x = carry.used.to(dev))
        self.alias_of: dict[str, _Vid] = {}
        # name -> element exprs of a tuple literal (for *args splats)
        self.tuple_bind: dict[str, list[ast.expr]] = {}
        # vid -> (time, line, callee fq, consumed param name)
        self.consumed: dict[_Vid, tuple[int, int, str, str]] = {}
        # (vid, time, line, where) — judged against call times at end
        self.escapes: list[tuple[_Vid, int, int, str]] = []
        self.time = 0
        self.callable_aliases: dict[str, ConsumingCallable] = {}

    # -- plumbing -----------------------------------------------------------

    def _emit(self, rule: str, line: int, message: str) -> None:
        self.owner.findings.append(Finding(
            rule=rule, path=self.path, line=line, symbol=self.symbol,
            message=message))

    def _vid(self, key: _Key) -> _Vid:
        return (key, self.gen.get(key, 0))

    def _describe(self, vid: _Vid) -> str:
        return vid[0][1]

    # -- value identity -----------------------------------------------------

    def _unwrap_alias(self, expr: ast.expr) -> ast.expr:
        while isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Attribute) and f.attr in _ALIAS_METHODS:
                expr = f.value  # x.to(dev) / x.contiguous()
                continue
            d = _dotted(f)
            if len(expr.args) != 1 or d is None or \
                    self.owner.index.resolve(self.mi, d) not in _ALIAS_FQS:
                break
            expr = expr.args[0]
        return expr

    def _is_snapshot_call(self, expr: ast.expr) -> bool:
        if not isinstance(expr, ast.Call):
            return False
        if isinstance(expr.func, ast.Attribute) and \
                expr.func.attr in _SNAPSHOT_METHODS and not expr.args:
            return True
        d = _dotted(expr.func)
        return d is not None and \
            self.owner.index.resolve(self.mi, d) in _SNAPSHOT_FQS

    def _value_id(self, expr: ast.expr) -> Optional[_Vid]:
        """The tracked identity of the buffer ``expr`` evaluates to, or
        None for fresh values (snapshots, computed results)."""
        expr = self._unwrap_alias(expr)
        if self._is_snapshot_call(expr):
            return None
        if isinstance(expr, ast.IfExp):
            # ``x.clone() if consume else x``: whichever arm runs, the
            # name is safe to read after the call exactly when the
            # snapshot arm covers the consuming case — the sanctioned
            # fix idiom.  A snapshot in either arm makes the value
            # fresh.
            if self._is_snapshot_call(self._unwrap_alias(expr.body)) or \
                    self._is_snapshot_call(self._unwrap_alias(expr.orelse)):
                return None
            return self._value_id(expr.body)
        if isinstance(expr, ast.Name):
            if expr.id in self.alias_of:
                return self.alias_of[expr.id]
            return self._vid(("name", expr.id))
        if isinstance(expr, ast.Attribute):
            d = _dotted(expr)
            if d is not None:
                return self._vid(("attr", d))
        return None

    # -- rebinding ----------------------------------------------------------

    def _bump_prefixed(self, root: str) -> None:
        """Rebinding ``carry`` also retires ``carry.used``'s identity —
        consumed entries keep their old (key, generation) vid, which no
        fresh read can match."""
        prefix = root + "."
        for key in list(self.gen):
            if key[0] == "attr" and key[1].startswith(prefix):
                self.gen[key] += 1

    def _rebind_name(self, name: str) -> None:
        self.alias_of.pop(name, None)
        self.tuple_bind.pop(name, None)
        key: _Key = ("name", name)
        self.gen[key] = self.gen.get(key, 0) + 1
        self._bump_prefixed(name)

    def _rebind_chain(self, dotted_ref: str) -> None:
        key: _Key = ("attr", dotted_ref)
        self.gen[key] = self.gen.get(key, 0) + 1
        self._bump_prefixed(dotted_ref)

    def _rebind_target(self, target: ast.expr) -> None:
        if isinstance(target, ast.Name):
            self._rebind_name(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._rebind_target(elt)
        elif isinstance(target, ast.Starred):
            self._rebind_target(target.value)
        elif isinstance(target, ast.Attribute):
            d = _dotted(target)
            if d is not None:
                self._rebind_chain(d)

    # -- the walk -----------------------------------------------------------

    def run(self, body: list[ast.stmt]) -> None:
        self.callable_aliases = self._scope_callable_aliases(body)
        self._stmts(body)
        self._finalize()

    def _scope_callable_aliases(
            self, body: list[ast.stmt]) -> dict[str, ConsumingCallable]:
        """``impl = _warm_repair if warm else _other`` (either arm
        consuming) and plain ``impl = _warm_repair`` bindings, prescanned
        so a call through the alias resolves."""
        out: dict[str, ConsumingCallable] = {}
        for node in _walk_no_nested(body):
            if not (isinstance(node, ast.Assign) and
                    len(node.targets) == 1 and
                    isinstance(node.targets[0], ast.Name)):
                continue
            value = node.value
            arms = [value.body, value.orelse] \
                if isinstance(value, ast.IfExp) else [value]
            for arm in arms:
                d = _dotted(arm)
                if d is None:
                    continue
                dc = self.owner._registry_lookup(self.mi, d)
                if dc is not None:
                    out[node.targets[0].id] = dc
                    break
        return out

    def _stmts(self, body: list[ast.stmt]) -> None:
        for st in body:
            self._stmt(st)

    def _stmt(self, st: ast.stmt) -> None:
        self.time += 1
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.owner._lint_body(
                self.mi, self.path, f"{self.symbol}.{st.name}", st.body)
            return
        if isinstance(st, ast.ClassDef):
            return
        if isinstance(st, ast.Return):
            if st.value is not None:
                self._expr(st.value)
            return
        if isinstance(st, ast.Assign):
            self._expr(st.value)
            for t in st.targets:
                self._assign_target(t, st.value, st.lineno)
            return
        if isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._expr(st.value)
                self._assign_target(st.target, st.value, st.lineno)
            return
        if isinstance(st, ast.AugAssign):
            self._expr(st.value)
            if isinstance(st.target, ast.Name):
                self._check_name_read(st.target.id, st.lineno)
                self._rebind_name(st.target.id)
            return
        if isinstance(st, ast.Expr):
            self._expr(st.value)
            return
        if isinstance(st, ast.If):
            self._expr(st.test)
            self._stmts(st.body)
            self._stmts(st.orelse)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._expr(st.iter)
            self._rebind_target(st.target)
            self._stmts(st.body)
            self._stmts(st.orelse)
            return
        if isinstance(st, ast.While):
            self._expr(st.test)
            self._stmts(st.body)
            self._stmts(st.orelse)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._expr(item.context_expr)
                if item.optional_vars is not None:
                    self._rebind_target(item.optional_vars)
            self._stmts(st.body)
            return
        if isinstance(st, ast.Try):
            self._stmts(st.body)
            for handler in st.handlers:
                self._stmts(handler.body)
            self._stmts(st.orelse)
            self._stmts(st.finalbody)
            return
        if isinstance(st, ast.Raise):
            if st.exc is not None:
                self._expr(st.exc)
            return
        if isinstance(st, ast.Assert):
            self._expr(st.test)
            return
        if isinstance(st, ast.Delete):
            for t in st.targets:
                self._rebind_target(t)
            return
        if isinstance(st, ast.Match):
            self._expr(st.subject)
            for case in st.cases:
                self._stmts(case.body)
            return
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _assign_target(self, target: ast.expr, value: ast.expr,
                       line: int) -> None:
        if isinstance(target, ast.Name):
            self._rebind_name(target.id)
            if isinstance(value, ast.Tuple):
                self.tuple_bind[target.id] = list(value.elts)
                return
            unwrapped = self._unwrap_alias(value)
            if isinstance(unwrapped, ast.IfExp) or \
                    isinstance(unwrapped, (ast.Name, ast.Attribute)):
                vid = self._value_id(value)
                if vid is not None:
                    self.alias_of[target.id] = vid
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._rebind_target(elt)
            return
        if isinstance(target, ast.Attribute):
            d = _dotted(target)
            if d is not None:
                self._rebind_chain(d)
            self._record_escape(value, line,
                                d if d is not None else "an attribute")
            return
        if isinstance(target, ast.Subscript):
            base = _dotted(target.value)
            self._record_escape(
                value, line,
                f"{base}[...]" if base is not None else "a container")
            return
        if isinstance(target, ast.Starred):
            self._rebind_target(target.value)

    def _record_escape(self, value: ast.expr, line: int,
                       where: str) -> None:
        vid = self._value_id(value)
        if vid is not None:
            self.escapes.append((vid, self.time, line, where))

    # -- expression side: reads, snapshots, consuming calls -----------------

    def _expr(self, expr: ast.expr) -> None:
        self._read_walk(expr)
        for node in _walk_no_nested([expr]):
            if isinstance(node, ast.Call):
                dc = self._consuming_callee(node)
                if dc is not None:
                    self._consume(node, dc)
                else:
                    self._call_escapes(node)

    def _consuming_callee(self,
                         call: ast.Call) -> Optional[ConsumingCallable]:
        d = _dotted(call.func)
        if d is None:
            return None
        if d in self.callable_aliases:
            return self.callable_aliases[d]
        return self.owner._registry_lookup(self.mi, d)

    def _consumed_arg_exprs(
            self, call: ast.Call,
            dc: ConsumingCallable) -> list[tuple[str, ast.expr, int]]:
        """(param, argument expr, line) per consumed parameter bound at
        this call, expanding ``*tuple_name`` splats through tuple-literal
        bindings."""
        pos: list[Optional[ast.expr]] = []
        for a in call.args:
            if isinstance(a, ast.Starred):
                if isinstance(a.value, ast.Name) and \
                        a.value.id in self.tuple_bind:
                    pos.extend(self.tuple_bind[a.value.id])
                else:
                    break  # opaque splat: positions beyond it unknown
            else:
                pos.append(a)
        out: list[tuple[str, ast.expr, int]] = []
        for i, param in enumerate(dc.params):
            if param in dc.consumed and i < len(pos):
                arg = pos[i]
                if arg is not None:
                    out.append((param, arg, call.lineno))
        for kw in call.keywords:
            if kw.arg is not None and kw.arg in dc.consumed:
                out.append((kw.arg, kw.value, call.lineno))
        return out

    def _consume(self, call: ast.Call, dc: ConsumingCallable) -> None:
        for param, arg, line in self._consumed_arg_exprs(call, dc):
            vid = self._value_id(arg)
            if vid is None:
                continue  # fresh value (snapshot/computed): safe to pass
            prior = self.consumed.get(vid)
            if prior is not None:
                self._emit(
                    "DON003", line,
                    f"{self._describe(vid)!r} is passed to consuming "
                    f"callable {dc.fq} but was already consumed at line "
                    f"{prior[1]} (by {prior[2]}) without being rebound — "
                    f"the second call gets a spent, single-use value")
            self.consumed[vid] = (self.time, line, dc.fq, param)

    def _call_escapes(self, call: ast.Call) -> None:
        """``self.cache.store(carry)``-shaped publication of a
        reference into longer-lived state."""
        if not (isinstance(call.func, ast.Attribute) and
                call.func.attr in _ESCAPE_METHODS):
            return
        receiver = _dotted(call.func.value)
        if receiver is None or \
                receiver.split(".")[0] not in ("self", "cls"):
            return
        where = f"{receiver}.{call.func.attr}()"
        for arg in list(call.args) + \
                [kw.value for kw in call.keywords if kw.arg is not None]:
            self._record_escape(arg, call.lineno, where)

    # -- reads --------------------------------------------------------------

    def _don001(self, vid: _Vid, line: int, what: str) -> None:
        _t, dline, callee, param = self.consumed[vid]
        self._emit(
            "DON001", line,
            f"{what} after its consuming call to {callee} at line "
            f"{dline} (consumed as {param!r}) — the value is single-use "
            f"by contract, and the callee may reuse its storage; "
            f"snapshot it before the call (.clone()) or rebind the name")

    def _check_name_read(self, name: str, line: int) -> None:
        for vid in (self._vid(("name", name)), self.alias_of.get(name)):
            if vid is not None and vid in self.consumed:
                self._don001(vid, line, f"reads {name!r}")
                return
        for elt in self.tuple_bind.get(name, []):
            vid = self._value_id(elt)
            if vid is not None and vid in self.consumed:
                self._don001(
                    vid, line,
                    f"reads {name!r}, which packs consumed operand "
                    f"{self._describe(vid)!r},")
                return

    def _check_chain_read(self, dotted_ref: str, line: int) -> None:
        parts = dotted_ref.split(".")
        head = parts[0]
        self._check_name_read(head, line)
        for cut in range(2, len(parts) + 1):
            prefix = ".".join(parts[:cut])
            vid = self._vid(("attr", prefix))
            if vid in self.consumed:
                self._don001(vid, line, f"reads {dotted_ref!r}")
                return

    def _read_walk(self, node: ast.AST) -> None:
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(node, ast.Call):
            # Snapshot of a consumed value: DON004, not DON001 — the
            # recipe is right, the placement (after the call) is the
            # bug.
            snap_arg: Optional[ast.expr] = None
            if self._is_snapshot_call(node):
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _SNAPSHOT_METHODS and \
                        not node.args:
                    snap_arg = node.func.value
                elif node.args:
                    snap_arg = node.args[0]
            if snap_arg is not None:
                vid = self._value_id(snap_arg)
                if vid is not None and vid in self.consumed:
                    _t, dline, callee, _param = self.consumed[vid]
                    self._emit(
                        "DON004", node.lineno,
                        f"snapshot of consumed operand "
                        f"{self._describe(vid)!r} AFTER its consuming "
                        f"call to {callee} at line {dline} — the "
                        f"snapshot reads a spent value; move it before "
                        f"the call (the `x.clone() if consume else x` "
                        f"idiom)")
                    for rest in node.args[1:]:
                        self._read_walk(rest)
                    return
            # The consumed arguments of a consuming call ARE the
            # consumption, not a use-after — suppress their root reads so
            # a second call reports one DON003, not DON001 noise on top.
            skip: set[int] = set()
            dc = self._consuming_callee(node)
            if dc is not None:
                skip = {id(arg) for _p, arg, _l
                        in self._consumed_arg_exprs(node, dc)}
            self._read_walk(node.func)
            for a in node.args:
                if dc is not None and isinstance(a, ast.Starred):
                    continue  # splat elements are covered by _consume
                if id(a) not in skip:
                    self._read_walk(a)
            for kw in node.keywords:
                if id(kw.value) not in skip:
                    self._read_walk(kw.value)
            return
        if isinstance(node, ast.Attribute):
            d = _dotted(node)
            if d is not None:
                if node.attr in _METADATA_ATTRS:
                    return  # shape/dtype metadata outlives the storage
                self._check_chain_read(d, node.lineno)
                return
            self._read_walk(node.value)
            return
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                self._check_name_read(node.id, node.lineno)
            return
        if isinstance(node, ast.IfExp):
            # Arms of the conditional-snapshot idiom are handled by
            # _value_id; reads inside still count.
            self._read_walk(node.test)
            self._read_walk(node.body)
            self._read_walk(node.orelse)
            return
        for child in ast.iter_child_nodes(node):
            self._read_walk(child)

    # -- scope end ----------------------------------------------------------

    def _finalize(self) -> None:
        for vid, t, line, where in self.escapes:
            record = self.consumed.get(vid)
            if record is not None and t < record[0]:
                self._emit(
                    "DON002", line,
                    f"consumed operand {self._describe(vid)!r} escapes "
                    f"into {where} before its consuming call to "
                    f"{record[2]} at line {record[1]} — the stored "
                    f"reference observes a spent value after the call; "
                    f"store a snapshot (.clone()) or store the call's "
                    f"output instead")
