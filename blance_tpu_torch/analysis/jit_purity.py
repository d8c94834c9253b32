# Port of blance_tpu/analysis/jit_purity.py for eager dispatch: the roots
# are a declared table (DEVICE_ROOTS) in place of jax.jit / shard_map
# discovery, JIT003 means a forced device sync (JIT002 folds into it), and
# JIT005 has no jit call to check.
"""Device-root purity lint: contracts for the code the solvers dispatch.

The reference lints what runs under a ``jax.jit`` trace.  The port has no
trace: its solvers dispatch eagerly, op by op, from Python.  What the
reference's rules protect still holds: the warm-replan identity contract
(plan/tensor.py: a warm replan is bitwise its cold twin, with pinned
tie-break bits) breaks the moment host nondeterminism enters a device
path, and every host read of a device value stalls the host until the
card drains its queue.  So the pass walks the same call graph as the
reference, rooted at :data:`DEVICE_ROOTS` — one row for each of the
port's counterparts of a reference trace root — and lints the reachable
set:

- JIT001 (all reached code): host nondeterminism — ``time.*``,
  ``random.*`` / ``numpy.random.*``, ``datetime.now``, ``os.urandom``,
  ``uuid.*``, and torch's global generator (``torch.rand`` / ``randn`` /
  ``randint`` / ``randperm`` / ``bernoulli`` / ``normal`` /
  ``multinomial`` called without ``generator=``).  A warm solve that
  draws a different sample than its cold twin is no longer its twin.
- JIT003 (all reached code): a forced device sync — ``bool()`` /
  ``int()`` / ``float()`` of a tensor, ``.item()``, ``.tolist()``,
  ``.cpu()`` or ``.numpy()`` of a tensor, or an ``if`` / ``while`` whose
  test is a tensor expression.  The port syncs on purpose, once per
  sweep and once per auction round; those sites are pinned in
  ``analysis/baseline.toml`` one line each with their reason, so a new
  per-round sync fails the gate.  This rule absorbs the reference's
  JIT002 (a Python branch on a traced value): in eager code such a
  branch is exactly a sync.
- JIT004 (all reached code): mutation of captured state — ``global`` /
  ``nonlocal`` declarations, or mutating method calls
  (append/extend/update/...) on names not bound in the local scope.
- JIT005 (static-argument hygiene) has nothing to check: the port has no
  ``jit``, so no ``static_argnames`` / ``donate_argnames`` to misdeclare.

What is a tensor is inferred without running anything.  A parameter is
one when its annotation is ``torch.Tensor`` (``Optional`` allowed); a
root's unannotated parameter without a literal default is one unless the
root hands it on to a callee parameter annotated as something else
(``constraints`` passed to ``constraints: Constraints``); a helper's
unannotated parameter is one when a reached call site passes it a
tensor.  A local is one when it is bound from an expression over
tensors, from a ``torch.*`` call, or from a package function whose
return annotation names ``Tensor``.  Shape facts (``x.shape``,
``x.ndim``, ``x.dtype``, ``x.device``, ``x.dim()``, ``x.numel()``,
``x.size()``, ``len(x)``, ``isinstance``) and ``is None`` tests are host
values, and a value already brought to the host (``.cpu()``,
``.numpy()``, ``.tolist()``, ``.item()``, or a coercion) is no longer a
tensor.
"""

from __future__ import annotations

import ast
from typing import Optional

from . import Finding
from ._astutil import FuncInfo, ModuleIndex, ModuleInfo
from ._astutil import dotted as _dotted

__all__ = ["JitPurityPass", "DEVICE_ROOTS"]

#: The port's device roots: fq name -> why (the reference's trace root it
#: stands for).  The sharded bodies (parallel/sharded.py) are the
#: reference's shard_map'd programs: each rank of a mesh runs one.
DEVICE_ROOTS: dict[str, str] = {
    "blance_tpu_torch.plan.tensor.solve_dense":
        "one auction sweep: the reference's jitted solve_dense",
    "blance_tpu_torch.plan.tensor._solve_dense_converged_impl":
        "the dense fixpoint: the reference's jitted "
        "_solve_dense_converged_impl",
    "blance_tpu_torch.plan.tensor._warm_repair":
        "the carry-seeded repair sweep: the reference's _warm_repair_jit "
        "and _warm_repair_donating",
    "blance_tpu_torch.plan.tensor._solve_sparse_converged_impl":
        "the sparse fixpoint: the reference's jitted "
        "_solve_sparse_converged_impl",
    "blance_tpu_torch.plan.tensor._warm_repair_sparse":
        "the sparse repair sweep: the reference's _warm_repair_sparse_jit "
        "and _warm_repair_sparse_donating",
    "blance_tpu_torch.plan.tensor._pipeline_cold_impl":
        "the cold plan pipeline: the reference's _pipeline_cold_jit and "
        "_pipeline_cold_donating",
    "blance_tpu_torch.plan.tensor._pipeline_warm_impl":
        "the warm plan pipeline: the reference's _pipeline_warm_jit and "
        "_pipeline_warm_donating",
    "blance_tpu_torch.plan.tensor._pipeline_sparse_cold_impl":
        "the sparse plan pipeline: the reference's _pipeline_sparse_jit "
        "and _pipeline_sparse_donating",
    "blance_tpu_torch.plan.tensor.carry_from_assignment":
        "the carry tables: the reference's _carry_used_jit",
    "blance_tpu_torch.parallel.sharded._dense_cold":
        "the sharded dense fixpoint: the reference's shard_map of "
        "solve_dense_converged (solve_dense_sharded, cold)",
    "blance_tpu_torch.parallel.sharded._dense_warm":
        "the sharded repair sweep: the reference's shard_map of "
        "_warm_repair (solve_dense_sharded, warm)",
    "blance_tpu_torch.parallel.sharded._sparse_cold":
        "the sharded sparse fixpoint: the reference's shard_map of "
        "_solve_sparse_converged_impl",
    "blance_tpu_torch.parallel.sharded._sparse_warm":
        "the sharded sparse repair: the reference's shard_map of "
        "_warm_repair_sparse",
    "blance_tpu_torch.parallel.sharded._pipeline_cold":
        "the sharded cold pipeline: the reference's _pipeline_sharded_fn "
        "(cold)",
    "blance_tpu_torch.parallel.sharded._pipeline_warm":
        "the sharded warm pipeline: the reference's _pipeline_sharded_fn "
        "(warm)",
    "blance_tpu_torch.parallel.sharded._fleet_cold":
        "the fleet cold batch over a mesh: the reference's "
        "_mesh_callable (cold)",
    "blance_tpu_torch.parallel.sharded._fleet_warm":
        "the fleet warm batch over a mesh: the reference's "
        "_mesh_callable (warm)",
    "blance_tpu_torch.plan.fleet._fleet_cold_batch":
        "the batched cold fixpoint: the reference's jitted vmap "
        "_fleet_cold_batch",
    "blance_tpu_torch.plan.fleet._fleet_warm_batch":
        "the batched repair sweep: the reference's jitted vmap "
        "_fleet_warm_batch",
    "blance_tpu_torch.moves.batch.diff_assignments":
        "the device move diff: the reference's jitted diff_assignments",
    "blance_tpu_torch.core.encode.pack_assignment_core":
        "the decode pack: the reference's jitted pack_assignment_core",
    "blance_tpu_torch.core.shortlist.build_shortlist_core":
        "the shortlist builder: the reference's _build_jit",
    "blance_tpu_torch.orchestrate.sched.ranks.rank_levels":
        "the scheduler's rank sweep: the reference's _rank_levels_jit",
    "blance_tpu_torch.ops.reduce2.priced_min2_argmin":
        "the min2 kernel's wrapper: the reference's pallas_call "
        "(ops/reduce2.py)",
    "blance_tpu_torch.ops.reduce2.min2_argmin":
        "the unpriced min2 entry: the reference's jitted min2_argmin",
    "blance_tpu_torch.ops.score_fused.fused_score_min2":
        "the in-kernel score's wrapper: the reference's pallas_call "
        "(ops/score_fused.py)",
    "blance_tpu_torch.ops.sparse2.sparse_priced_min2":
        "the sparse kernel's wrapper: the reference's pallas_call "
        "(ops/sparse2.py)",
    "blance_tpu_torch.ops.sparse2.sparse_priced_min2_cand":
        "the sparse kernel's gathered-price entry, the one the sparse "
        "engine calls (the same kernel source as sparse_priced_min2)",
}

# fq-prefix -> why it is impure on a device path.
_NONDET_PREFIXES = {
    "time.time": "wall-clock read",
    "time.time_ns": "wall-clock read",
    "time.perf_counter": "wall-clock read",
    "time.monotonic": "wall-clock read",
    "time.sleep": "host sleep",
    "random.": "host PRNG (pass a seeded torch.Generator)",
    "numpy.random.": "host PRNG (pass a seeded torch.Generator)",
    "datetime.datetime.now": "wall-clock read",
    "datetime.date.today": "wall-clock read",
    "os.urandom": "host entropy",
    "uuid.": "host entropy",
}

#: torch's global generator: a draw is process state unless the call
#: names its own ``generator=``.
_TORCH_GLOBAL_RNG = frozenset({
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.bernoulli", "torch.normal", "torch.multinomial",
})

_MUTATING_METHODS = {
    "append", "extend", "insert", "remove", "pop", "clear", "update",
    "setdefault", "add", "discard", "popitem",
}

_COERCIONS = {"float", "int", "bool"}

#: Tensor methods that copy the value to the host (the sync itself).
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

#: Attributes and methods that are host facts about a tensor.
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "dim", "numel", "size", "stride", "element_size",
                 "data_ptr", "is_contiguous", "requires_grad"}

#: Builtins whose result is a host fact about their argument.
_STATIC_CALLS = {"len", "isinstance", "hasattr", "type", "id", "callable"}

#: ``torch.*`` callables that return host values, not tensors.
_TORCH_HOST_FNS = {"torch.device", "torch.is_tensor",
                   "torch.get_default_dtype", "torch.finfo", "torch.iinfo",
                   "torch.Size"}


class JitPurityPass:
    """Whole-program pass: build the index, mark the declared roots,
    walk, lint.

    ``device_roots`` exists for the fixture tests — the real CLI always
    runs the module-level table."""

    def __init__(self, files: list[str], repo_root: str, *,
                 device_roots: Optional[dict[str, str]] = None) -> None:
        self.repo_root = repo_root
        self.index = ModuleIndex(files, repo_root)
        self.modules: dict[str, ModuleInfo] = self.index.modules
        self.device_roots = DEVICE_ROOTS if device_roots is None \
            else device_roots
        self.findings: list[Finding] = []
        for rel, line, msg in self.index.parse_errors:
            self.findings.append(Finding(
                rule="JIT000", path=rel, line=line, symbol="",
                message=f"file does not parse: {msg}"))

    # -- roots and reachability ---------------------------------------------

    def _roots(self) -> list[FuncInfo]:
        roots = []
        for fq in self.device_roots:
            fn = self.index.lookup_fq(fq)
            if fn is not None:
                fn.is_root = True
                roots.append(fn)
        return roots

    def _reachable(self) -> list[FuncInfo]:
        return self.index.reachable(self._roots())

    # -- the lint -----------------------------------------------------------

    def run(self) -> list[Finding]:
        reached = self._reachable()
        params = self._tensor_params_by_function(reached)
        for fn in reached:
            self._lint_function(fn, params[fn.fq])
        return self.findings

    def _emit(self, fn: FuncInfo, rule: str, line: int,
              message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=fn.path, line=line, symbol=fn.qualname,
            message=message))

    def _local_names(self, fn: FuncInfo) -> set[str]:
        names = set(fn.params)
        for node in ast.walk(fn.node):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    for sub in ast.walk(t):
                        # Only true bindings: in ``x[k] = v`` / ``x.a = v``
                        # the base name is a Load — x stays captured.
                        if isinstance(sub, ast.Name) and \
                                isinstance(sub.ctx, ast.Store):
                            names.add(sub.id)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                for sub in ast.walk(node.target):
                    if isinstance(sub, ast.Name):
                        names.add(sub.id)
            elif isinstance(node, ast.comprehension):
                for sub in ast.walk(node.target):
                    if isinstance(sub, ast.Name):
                        names.add(sub.id)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None:
                        for sub in ast.walk(item.optional_vars):
                            if isinstance(sub, ast.Name):
                                names.add(sub.id)
        return names

    def _lint_function(self, fn: FuncInfo, params: set[str]) -> None:
        mi = self.modules[fn.module]
        local = self._local_names(fn)
        tensors = self._tensor_names(fn, mi, params)

        for node in ast.walk(fn.node):
            # JIT004: captured-state mutation
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                kind = "global" if isinstance(node, ast.Global) \
                    else "nonlocal"
                self._emit(fn, "JIT004", node.lineno,
                           f"{kind} mutation on a device path: every "
                           f"dispatch through this root writes process "
                           f"state")
                continue
            if isinstance(node, (ast.If, ast.While)):
                if self._is_tensor_expr(node.test, tensors, mi):
                    kind = "if" if isinstance(node, ast.If) else "while"
                    self._emit(
                        fn, "JIT003", node.lineno,
                        f"Python {kind} on a tensor expression: a forced "
                        f"device sync (the host waits for the card to "
                        f"drain its queue)")
                continue
            if not isinstance(node, ast.Call):
                continue

            dotted = _dotted(node.func)
            if dotted is not None:
                self._jit001(fn, node, self.index.resolve(mi, dotted))

            # JIT004: mutating a captured name
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATING_METHODS and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id not in local:
                self._emit(
                    fn, "JIT004", node.lineno,
                    f"mutating call {node.func.value.id}."
                    f"{node.func.attr}() targets captured state — every "
                    f"dispatch through this root writes process state")

            # JIT003: host copies of a tensor
            if isinstance(node.func, ast.Name) and \
                    node.func.id in _COERCIONS and len(node.args) == 1 and \
                    self._is_tensor_expr(node.args[0], tensors, mi):
                self._emit(
                    fn, "JIT003", node.lineno,
                    f"{node.func.id}() of a tensor: a forced device sync")
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SYNC_METHODS and not node.args and \
                    self._is_tensor_expr(node.func.value, tensors, mi):
                self._emit(
                    fn, "JIT003", node.lineno,
                    f".{node.func.attr}() of a tensor: a forced device "
                    f"sync")

    def _jit001(self, fn: FuncInfo, node: ast.Call, fq: str) -> None:
        if fq in _TORCH_GLOBAL_RNG:
            if not any(kw.arg == "generator" for kw in node.keywords):
                self._emit(
                    fn, "JIT001", node.lineno,
                    f"call to {fq} without generator= on a device path: "
                    f"torch's global generator is process state, so a "
                    f"warm solve and its cold twin draw different "
                    f"samples")
            return
        for prefix, why in _NONDET_PREFIXES.items():
            hit = fq == prefix or (prefix.endswith(".") and
                                   fq.startswith(prefix))
            if hit:
                self._emit(
                    fn, "JIT001", node.lineno,
                    f"call to {fq} on a device path: {why}; a warm solve "
                    f"and its cold twin no longer compute the same thing")
                return

    # -- which expressions are tensors --------------------------------------

    @staticmethod
    def _annotation(fn: FuncInfo, name: str) -> Optional[bool]:
        """True when ``name``'s annotation is a tensor (``torch.Tensor``,
        optionally ``Optional``), False when it is something else, None
        when the parameter is unannotated (or not there)."""
        args = fn.node.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if a.arg != name:
                continue
            if a.annotation is None:
                return None
            text = ast.unparse(a.annotation).replace(" ", "")
            for wrap in ("Optional[", "typing.Optional["):
                if text.startswith(wrap) and text.endswith("]"):
                    text = text[len(wrap):-1]
            return text.removesuffix("|None") in ("torch.Tensor", "Tensor")
        return None

    def _declared_tensor_params(self, fn: FuncInfo) -> set[str]:
        """Parameters annotated as tensors; on a root also every
        unannotated one without a literal default (a root's operands are
        its arrays) that it does not hand, by name, to a callee parameter
        annotated as something else (``constraints`` passed on to
        ``constraints: Constraints`` is a host value)."""
        mi = self.modules[fn.module]
        host: set[str] = set()
        if fn.is_root:
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                d = _dotted(node.func)
                callee = self.index.lookup_function(mi, d) \
                    if d is not None else None
                if callee is None:
                    continue
                for name, arg in self._bound_params(callee, node).items():
                    if isinstance(arg, ast.Name) and \
                            self._annotation(callee, name) is False:
                        host.add(arg.id)
        out = set()
        for a in fn.node.args.posonlyargs + fn.node.args.args + \
                fn.node.args.kwonlyargs:
            if a.arg in ("self", "cls"):
                continue
            ann = self._annotation(fn, a.arg)
            if ann or (ann is None and fn.is_root and
                       a.arg not in fn.defaulted and a.arg not in host):
                out.add(a.arg)
        return out

    def _tensor_params_by_function(
            self, reached: list[FuncInfo]) -> dict[str, set[str]]:
        """Which parameters of each reached function hold tensors: the
        declared ones, plus every one that some reached call site passes
        a tensor (to a fixpoint over the call edges)."""
        params = {fn.fq: self._declared_tensor_params(fn) for fn in reached}
        for _ in range(len(reached) + 1):
            grew = False
            for fn in reached:
                mi = self.modules[fn.module]
                tensors = self._tensor_names(fn, mi, params[fn.fq])
                for node in ast.walk(fn.node):
                    if not isinstance(node, ast.Call):
                        continue
                    d = _dotted(node.func)
                    callee = self.index.lookup_function(mi, d) \
                        if d is not None else None
                    if callee is None or callee.fq not in params:
                        continue
                    for name, arg in \
                            self._bound_params(callee, node).items():
                        if name not in params[callee.fq] and \
                                self._annotation(callee, name) is None and \
                                self._is_tensor_expr(arg, tensors, mi):
                            params[callee.fq].add(name)
                            grew = True
            if not grew:
                break
        return params

    @staticmethod
    def _bound_params(callee: FuncInfo,
                      call: ast.Call) -> dict[str, ast.expr]:
        """Parameter name -> argument expression at ``call`` (positions
        past a ``*splat`` are unknown and left out)."""
        args = callee.node.args
        pos = [a.arg for a in args.posonlyargs + args.args]
        if pos and pos[0] in ("self", "cls") and "." in callee.qualname:
            pos = pos[1:]
        out: dict[str, ast.expr] = {}
        for name, arg in zip(pos, call.args):
            if isinstance(arg, ast.Starred):
                break
            out[name] = arg
        for kw in call.keywords:
            if kw.arg is not None:
                out[kw.arg] = kw.value
        return out

    def _tensor_names(self, fn: FuncInfo, mi: ModuleInfo,
                      params: set[str]) -> set[str]:
        """Parameters and locals that hold tensors (to a fixpoint over the
        function's assignments)."""
        tensors = set(params)
        binds: list[tuple[ast.expr, ast.expr]] = []
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    binds.append((t, node.value))
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and \
                    node.value is not None:
                binds.append((node.target, node.value))
            elif isinstance(node, ast.NamedExpr):
                binds.append((node.target, node.value))
        for _ in range(4):
            grew = False
            for target, value in binds:
                for tgt, val in self._pairs(target, value):
                    if isinstance(tgt, ast.Name) and \
                            tgt.id not in tensors and \
                            self._is_tensor_expr(val, tensors, mi):
                        tensors.add(tgt.id)
                        grew = True
            if not grew:
                break
        return tensors

    @staticmethod
    def _pairs(target: ast.expr, value: ast.expr):
        """(target, value) pairs, splitting ``a, b = x, y`` element-wise
        (an unsplittable tuple target takes the whole value)."""
        if isinstance(target, (ast.Tuple, ast.List)) and \
                isinstance(value, (ast.Tuple, ast.List)) and \
                len(target.elts) == len(value.elts):
            out = []
            for t, v in zip(target.elts, value.elts):
                out.extend(JitPurityPass._pairs(t, v))
            return out
        if isinstance(target, (ast.Tuple, ast.List)):
            return [(t.value if isinstance(t, ast.Starred) else t, value)
                    for t in target.elts]
        return [(target, value)]

    def _is_tensor_expr(self, expr: ast.AST, tensors: set[str],
                        mi: ModuleInfo) -> bool:
        """True when evaluating ``expr`` yields (or branches on) a device
        value: it references a tensor other than through a host fact or
        a host copy, or calls a ``torch.*`` function that returns one."""
        if isinstance(expr, ast.Name):
            return expr.id in tensors
        if isinstance(expr, ast.Constant):
            return False
        if isinstance(expr, ast.Compare) and \
                all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return False  # presence tests are host facts
        if isinstance(expr, ast.Attribute):
            if expr.attr in _STATIC_ATTRS:
                return False
            return self._is_tensor_expr(expr.value, tensors, mi)
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Name) and \
                    (f.id in _STATIC_CALLS or f.id in _COERCIONS):
                return False  # a host fact, or a host copy already
            if isinstance(f, ast.Attribute):
                if f.attr in _STATIC_ATTRS or f.attr in _SYNC_METHODS:
                    return False
            d = _dotted(f)
            if d is not None:
                fq = self.index.resolve(mi, d)
                if fq.startswith("torch."):
                    return fq not in _TORCH_HOST_FNS and \
                        not fq.startswith("torch.cuda.")
                # A function of the package says what it returns.
                callee = self.index.lookup_function(mi, d)
                returns = getattr(callee.node, "returns", None) \
                    if callee is not None else None
                if returns is not None:
                    return "Tensor" in ast.unparse(returns)
            # a method of a tensor (x.any(), x.sum(), ...)
            if isinstance(f, ast.Attribute) and \
                    self._is_tensor_expr(f.value, tensors, mi):
                return True
            args = list(expr.args) + [kw.value for kw in expr.keywords]
            return any(self._is_tensor_expr(a.value if isinstance(
                a, ast.Starred) else a, tensors, mi) for a in args)
        if isinstance(expr, (ast.Lambda, ast.ListComp, ast.SetComp,
                             ast.DictComp, ast.GeneratorExp, ast.Dict,
                             ast.JoinedStr)):
            return False
        return any(self._is_tensor_expr(child, tensors, mi)
                   for child in ast.iter_child_nodes(expr)
                   if isinstance(child, ast.expr))
