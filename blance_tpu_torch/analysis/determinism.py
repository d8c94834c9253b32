# Copied from blance_tpu/analysis/determinism.py; the tables name the
# port's modules and its own environment reads, and DET002 also covers
# torch's global generator.
"""Determinism lint: static taint analysis for the bit-identical-replay
contract.

The keystone dynamic guarantee — committed traces (sim event logs, fleet
logs, crash-storm journals, rendered exposition text) replay
byte-identically — is enforced by diffing artifacts, which finds a
nondeterminism bug long after the offending line merged.  This pass is
the static twin (TOAST's thesis, arXiv:2508.15010): every source of
replay nondeterminism becomes a build-failing finding the moment it is
written.

The pass builds the shared cross-module call graph
(:class:`._astutil.ModuleIndex`) rooted at the declarative
:data:`REPLAY_ROOTS` table — the converge-cycle engine, the
simulator/fleetsim/crashsim runners, the durability journal/recovery,
and the canonical log/exposition renderers — and walks the reachable
set (``self.method`` edges included; replay code is method-heavy):

- **DET001** wall-clock call (``time.time/monotonic/perf_counter``,
  ``datetime.now``, raw ``loop.time()``) outside a declared
  :data:`CLOCK_SEAMS` entry.  Replayed time must come from the injected
  clock (``Recorder.now`` / ``DeterministicLoop`` virtual time) or the
  single host perf seam (``utils.hostclock.perf_now``).
- **DET002** unseeded randomness: ``random`` module-level functions,
  ``random.Random()`` with no seed, ``numpy.random.*``, ``uuid.*``,
  ``os.urandom``, ``secrets.*``.  Seeded ``random.Random(seed)``
  construction is the sanctioned pattern.
- **DET003** unordered iteration flowing into a serialization sink: a
  ``set``/``frozenset``-provenance value passed to a
  :data:`SERIALIZED_SINKS` entry (journal append, ``canonical_*_text``,
  ``render_prometheus``, ``atomic_write_*``) without ``sorted()`` on the
  path.
- **DET004** ``json.dumps`` without ``sort_keys=True`` (package-wide:
  every dumps in this codebase feeds a canonical artifact, an HTTP
  payload or the CLI).  A pass-through ``sort_keys=sort_keys`` keyword
  is clean — the decision is the caller's.
- **DET005** ordering keyed on ``hash()`` / ``id()`` — ``sorted`` /
  ``.sort`` / ``min`` / ``max`` with a key that calls either — the
  PYTHONHASHSEED / allocator hazard.  Identity uses of ``id()`` outside
  ordering are fine.
- **DET006** ``os.environ`` / ``os.getenv`` read outside the declared
  :data:`CONFIG_KNOBS` table: an undeclared knob is ambient state a
  replay cannot pin.

Findings fold through ``analysis/baseline.toml`` exactly like
JIT/ASY/RACE rules.  The tables are reality-guarded by
``tests/test_torch_analysis.py`` (every entry must resolve to a real
symbol), the same pattern as the race lint's ``SHARED_STATE``.
"""

from __future__ import annotations

import ast
from typing import Optional

from . import Finding
from ._astutil import FuncInfo, ModuleIndex, ModuleInfo
from ._astutil import dotted as _dotted

__all__ = ["DeterminismPass", "REPLAY_ROOTS", "CLOCK_SEAMS",
           "SERIALIZED_SINKS", "CONFIG_KNOBS"]


# -- the declarative tables --------------------------------------------------
#
# Dotted-prefix matching throughout: an entry covers the named symbol and
# everything nested under it (a module entry covers the whole module, a
# class entry every method).

#: Replay-rooted code: everything reachable from these must be
#: deterministic given (scenario, seed, journal).  fq prefix -> why.
REPLAY_ROOTS: dict[str, str] = {
    "blance_tpu_torch.control":
        "CycleEngine: every control loop's debounce/converge machine",
    "blance_tpu_torch.rebalance":
        "RebalanceController drives planning/orchestration under the "
        "injected clock; its event stream is journaled",
    "blance_tpu_torch.fleetloop":
        "fleet controller: N tenants' cycles coalesced into shared "
        "dispatches; feeds the fleet log",
    "blance_tpu_torch.plan.service":
        "shared plan service: admission windows and batch solves on the "
        "replayed event loop",
    "blance_tpu_torch.orchestrate.orchestrator":
        "move orchestration: progress stream is asserted byte-stable "
        "across schedule explorations",
    "blance_tpu_torch.durability":
        "journal encode/replay/recovery: the crash-replay artifact "
        "itself",
    "blance_tpu_torch.testing.simulate":
        "scenario runner: produces the committed sim event logs",
    "blance_tpu_torch.testing.fleetsim":
        "fleet scenario runner: produces the committed fleet logs",
    "blance_tpu_torch.testing.crashsim":
        "crash-storm runner: produces the committed crash logs",
    "blance_tpu_torch.testing.scenarios":
        "scenario builders: seed -> identical event list is the replay "
        "premise",
    "blance_tpu_torch.obs.expo.render_prometheus":
        "canonical exposition text: diffed byte-for-byte in tests",
    "blance_tpu_torch.utils.trace.PhaseTimer":
        "phase report shape is pinned by tests; timing must flow "
        "through the host perf seam",
}

#: Declared clock boundaries: the only places reachable-from-a-root code
#: may read a clock that is not replayed state.  fq prefix -> why.
CLOCK_SEAMS: dict[str, str] = {
    "blance_tpu_torch.utils.hostclock":
        "THE host perf-clock seam: perf_now() wraps the injectable "
        "clock; host-phase timing is diagnostic, never replayed",
    "blance_tpu_torch.plan.service.PlanService._admit_batch":
        "loop.time() reads the INJECTED event loop's clock for the "
        "admission deadline — virtual time under DeterministicLoop",
    "blance_tpu_torch.testing.simulate._sim_main":
        "loop.time() is DeterministicLoop virtual time (the loop is "
        "constructed by run_scenario)",
    "blance_tpu_torch.testing.fleetsim._fleet_main":
        "loop.time() is DeterministicLoop virtual time (the loop is "
        "constructed by run_fleet_scenario)",
    "blance_tpu_torch.testing.crashsim._run_life":
        "loop.time() is DeterministicLoop virtual time (the loop is "
        "constructed by run_crash_scenario)",
}

#: Serialization sinks: what reaches these ends up in a canonical
#: artifact, so iteration order on the way in must be pinned.  Matching
#: is by dotted suffix (``journal.append`` also matches
#: ``self._journal.append``; leading underscores are ignored per
#: segment).  suffix -> what the sink writes.
SERIALIZED_SINKS: dict[str, str] = {
    "journal.append": "durability journal records (replayed on recovery)",
    "canonical_log_text": "committed sim event log",
    "canonical_fleet_log_text": "committed fleet event log",
    "crash_log_text": "committed crash-storm log",
    "render_prometheus": "canonical exposition text",
    "atomic_write_json": "persisted JSON artifact",
    "atomic_write_text": "persisted text artifact",
}

#: Declared environment knobs: the only functions reachable from a
#: replay root that may read ``os.environ``.  fq prefix -> the knob.
CONFIG_KNOBS: dict[str, str] = {
    "blance_tpu_torch.utils.atomicio.fsync_enabled":
        "BLANCE_WAL_FSYNC: durability/latency trade-off, read per "
        "write on purpose so crash tests can flip it mid-run",
}
# The port's other environment reads need no row, because the pass
# reports none of them: ops/_build.py reads NVCC in code that the kernel
# wrappers reach only through a function-local import, which the call
# graph does not follow (and a compiler path is no replayed state);
# orchestrate/sched/ranks.py reads BLANCE_SCHED_DEVICE_THRESHOLD once at
# import, outside every function the walk visits; and analysis/
# membudget.py's knobs sit in analysis/, which the lints do not walk
# (see analysis._iter_py_files).


# -- rule constants ----------------------------------------------------------

_WALL_CLOCK = {
    "time.time": "wall-clock read",
    "time.time_ns": "wall-clock read",
    "time.monotonic": "wall-clock read",
    "time.monotonic_ns": "wall-clock read",
    "time.perf_counter": "host perf-clock read",
    "time.perf_counter_ns": "host perf-clock read",
    "datetime.datetime.now": "wall-clock read",
    "datetime.datetime.utcnow": "wall-clock read",
    "datetime.date.today": "wall-clock read",
}

_TORCH_GLOBAL_RNG = "torch's global generator is process state, not " \
    "scenario state (pass generator=)"

_RANDOM_PREFIXES = {
    "random.": "module-level random shares global unseeded state",
    "numpy.random.": "numpy global PRNG is process state, not scenario "
                     "state",
    "uuid.": "uuid draws host entropy",
    "secrets.": "secrets draws host entropy",
    "os.urandom": "host entropy",
    # torch's global generator: the port's counterpart of the reference's
    # explicit jax.random keys.  A draw with ``generator=`` is seeded
    # state the caller owns (see _det002).
    "torch.rand": _TORCH_GLOBAL_RNG,
    "torch.randn": _TORCH_GLOBAL_RNG,
    "torch.randint": _TORCH_GLOBAL_RNG,
    "torch.randperm": _TORCH_GLOBAL_RNG,
    "torch.bernoulli": _TORCH_GLOBAL_RNG,
    "torch.normal": _TORCH_GLOBAL_RNG,
    "torch.multinomial": _TORCH_GLOBAL_RNG,
}

_ORDERING_FNS = {"sorted", "min", "max"}


def _suffix_matches(dotted_ref: str, entry: str) -> bool:
    """True when ``dotted_ref``'s trailing segments equal ``entry``'s
    (leading underscores stripped per segment, so ``self._journal.append``
    matches ``journal.append``)."""
    want = entry.split(".")
    got = dotted_ref.split(".")
    if len(got) < len(want):
        return False
    tail = got[len(got) - len(want):]
    return all(g.lstrip("_") == w for g, w in zip(tail, want))


class DeterminismPass:
    """Whole-program pass: index, root at REPLAY_ROOTS, walk, lint.

    The table keyword arguments exist for the fixture tests — the real
    CLI always runs the module-level tables."""

    def __init__(self, files: list[str], repo_root: str, *,
                 replay_roots: Optional[dict[str, str]] = None,
                 clock_seams: Optional[dict[str, str]] = None,
                 serialized_sinks: Optional[dict[str, str]] = None,
                 config_knobs: Optional[dict[str, str]] = None) -> None:
        self.index = ModuleIndex(files, repo_root)
        self.replay_roots = REPLAY_ROOTS if replay_roots is None \
            else replay_roots
        self.clock_seams = CLOCK_SEAMS if clock_seams is None \
            else clock_seams
        self.serialized_sinks = SERIALIZED_SINKS if serialized_sinks is None \
            else serialized_sinks
        self.config_knobs = CONFIG_KNOBS if config_knobs is None \
            else config_knobs
        self.findings: list[Finding] = []
        for rel, line, msg in self.index.parse_errors:
            self.findings.append(Finding(
                rule="DET000", path=rel, line=line, symbol="",
                message=f"file does not parse: {msg}"))

    # -- matching helpers ---------------------------------------------------

    @staticmethod
    def _prefix_entry(fq: str, table: dict[str, str]) -> Optional[str]:
        for key in table:
            if fq == key or fq.startswith(key + "."):
                return key
        return None

    def _sink_entry(self, dotted_ref: str) -> Optional[str]:
        for key in self.serialized_sinks:
            if _suffix_matches(dotted_ref, key):
                return key
        return None

    def _roots(self) -> list[FuncInfo]:
        return [fn for mi in self.index.modules.values()
                for fn in mi.functions.values()
                if self._prefix_entry(fn.fq, self.replay_roots) is not None]

    # -- the run ------------------------------------------------------------

    def run(self) -> list[Finding]:
        reached = self.index.reachable(self._roots(), self_edges=True)
        for fn in reached:
            self._lint_function(fn)
        self._lint_json_dumps()
        return self.findings

    def _emit(self, rule: str, path: str, line: int, symbol: str,
              message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=path, line=line, symbol=symbol,
            message=message))

    # -- per-function rules (replay-reachable set) --------------------------

    def _lint_function(self, fn: FuncInfo) -> None:
        mi = self.index.modules[fn.module]
        in_clock_seam = self._prefix_entry(fn.fq, self.clock_seams) \
            is not None
        in_knob = self._prefix_entry(fn.fq, self.config_knobs) is not None
        provenance = self._set_provenance(fn)

        for node in ast.walk(fn.node):
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load) and not in_knob:
                ref = _dotted(node.value)
                if ref is not None and \
                        self.index.resolve(mi, ref) == "os.environ":
                    self._emit(
                        "DET006", fn.path, node.lineno, fn.qualname,
                        "os.environ read in replay-rooted code outside "
                        "the declared CONFIG_KNOBS table — an undeclared "
                        "knob is ambient state a replay cannot pin")
            if not isinstance(node, ast.Call):
                continue
            ref = _dotted(node.func)
            fq = self.index.resolve(mi, ref) if ref is not None else None

            if fq is not None:
                if not in_clock_seam:
                    self._det001(fn, node, ref or "", fq)
                self._det002(fn, node, fq)
                if not in_knob and fq in ("os.getenv", "os.environ.get"):
                    self._emit(
                        "DET006", fn.path, node.lineno, fn.qualname,
                        f"{fq} read in replay-rooted code outside the "
                        f"declared CONFIG_KNOBS table — an undeclared "
                        f"knob is ambient state a replay cannot pin")

            self._det005(fn, node)
            if ref is not None:
                sink = self._sink_entry(ref)
                if sink is not None:
                    self._det003(fn, node, sink, provenance)

    def _det001(self, fn: FuncInfo, node: ast.Call, ref: str,
                fq: str) -> None:
        why = _WALL_CLOCK.get(fq)
        segs = ref.split(".")
        is_loop_time = len(segs) >= 2 and segs[-1] == "time" and \
            segs[-2].lstrip("_") == "loop"
        if why is None and not is_loop_time:
            return
        what = f"raw loop.time() ({ref})" if why is None else f"{fq}: {why}"
        self._emit(
            "DET001", fn.path, node.lineno, fn.qualname,
            f"{what} reached from a replay root outside the declared "
            f"CLOCK_SEAMS — replayed time must come from the injected "
            f"clock (Recorder.now / DeterministicLoop) or "
            f"utils.hostclock.perf_now")

    def _det002(self, fn: FuncInfo, node: ast.Call, fq: str) -> None:
        if fq == "random.Random":
            if not node.args and not node.keywords:
                self._emit(
                    "DET002", fn.path, node.lineno, fn.qualname,
                    "random.Random() without a seed in replay-rooted "
                    "code — pass an explicit scenario-derived seed")
            return  # seeded construction is the sanctioned pattern
        for prefix, why in _RANDOM_PREFIXES.items():
            hit = fq == prefix or (prefix.endswith(".") and
                                   fq.startswith(prefix))
            if hit and why is _TORCH_GLOBAL_RNG and \
                    any(kw.arg == "generator" for kw in node.keywords):
                return  # an explicit generator is caller-owned state
            if hit:
                self._emit(
                    "DET002", fn.path, node.lineno, fn.qualname,
                    f"call to {fq} in replay-rooted code: {why}; draw "
                    f"from a seeded random.Random(seed) instead")
                return

    def _det003(self, fn: FuncInfo, call: ast.Call, sink: str,
                provenance: set[str]) -> None:
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            exempt = self._names_under_sorted(arg)
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Name) and sub.id in provenance \
                        and sub.id not in exempt:
                    self._emit(
                        "DET003", fn.path, call.lineno, fn.qualname,
                        f"set-provenance value {sub.id!r} flows into "
                        f"serialization sink {sink!r} "
                        f"({self.serialized_sinks[sink]}) without "
                        f"sorted() on the path — set iteration order is "
                        f"not replay-stable")
                elif isinstance(sub, (ast.Set, ast.SetComp)) or (
                        isinstance(sub, ast.Call) and
                        isinstance(sub.func, ast.Name) and
                        sub.func.id in ("set", "frozenset")):
                    if id(sub) not in self._nodes_under_sorted(arg):
                        self._emit(
                            "DET003", fn.path, call.lineno, fn.qualname,
                            f"inline set expression flows into "
                            f"serialization sink {sink!r} "
                            f"({self.serialized_sinks[sink]}) without "
                            f"sorted() on the path — set iteration "
                            f"order is not replay-stable")

    def _det005(self, fn: FuncInfo, node: ast.Call) -> None:
        is_ordering = (isinstance(node.func, ast.Name) and
                       node.func.id in _ORDERING_FNS) or \
            (isinstance(node.func, ast.Attribute) and
             node.func.attr == "sort")
        if not is_ordering:
            return
        for kw in node.keywords:
            if kw.arg != "key":
                continue
            for sub in ast.walk(kw.value):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Name) and \
                        sub.func.id in ("hash", "id"):
                    self._emit(
                        "DET005", fn.path, node.lineno, fn.qualname,
                        f"ordering keyed on {sub.func.id}(): "
                        f"{'PYTHONHASHSEED' if sub.func.id == 'hash' else 'allocator address'}"
                        f"-dependent order is not replay-stable — key on "
                        f"the value's own fields")
                    break

    # -- set-provenance tracking (intra-function, one propagation hop) ------

    def _set_provenance(self, fn: FuncInfo) -> set[str]:
        assigns: list[tuple[str, ast.expr]] = []
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                assigns.append((node.targets[0].id, node.value))
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name) and \
                    node.value is not None:
                assigns.append((node.target.id, node.value))
        tainted: set[str] = set()
        for _ in range(2):  # one extra round: x = set(); y = list(x)
            for name, value in assigns:
                if self._is_set_expr(value, tainted):
                    tainted.add(name)
                elif self._clears_provenance(value):
                    tainted.discard(name)
        return tainted

    @staticmethod
    def _is_set_expr(value: ast.expr, tainted: set[str]) -> bool:
        if isinstance(value, (ast.Set, ast.SetComp)):
            return True
        if isinstance(value, ast.Name):
            return value.id in tainted
        if isinstance(value, ast.Call):
            f = value.func
            if isinstance(f, ast.Name) and f.id in ("set", "frozenset"):
                return True
            # list(x)/tuple(x) of a tainted name stays unordered-derived.
            if isinstance(f, ast.Name) and f.id in ("list", "tuple") and \
                    value.args and isinstance(value.args[0], ast.Name) and \
                    value.args[0].id in tainted:
                return True
        if isinstance(value, ast.BinOp) and \
                isinstance(value.op, (ast.BitOr, ast.BitAnd, ast.Sub)):
            # set algebra on a tainted operand
            for side in (value.left, value.right):
                if isinstance(side, ast.Name) and side.id in tainted:
                    return True
        return False

    @staticmethod
    def _clears_provenance(value: ast.expr) -> bool:
        return isinstance(value, ast.Call) and \
            isinstance(value.func, ast.Name) and value.func.id == "sorted"

    @staticmethod
    def _names_under_sorted(arg: ast.expr) -> set[str]:
        out: set[str] = set()
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Name) and \
                    sub.func.id == "sorted":
                for inner in ast.walk(sub):
                    if isinstance(inner, ast.Name):
                        out.add(inner.id)
        return out

    @staticmethod
    def _nodes_under_sorted(arg: ast.expr) -> set[int]:
        out: set[int] = set()
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Name) and \
                    sub.func.id == "sorted":
                for inner in ast.walk(sub):
                    out.add(id(inner))
        return out

    # -- DET004: json.dumps hygiene (package-wide) --------------------------

    def _lint_json_dumps(self) -> None:
        for mi in self.index.modules.values():
            for node in ast.walk(mi.tree):
                if not isinstance(node, ast.Call):
                    continue
                ref = _dotted(node.func)
                if ref is None or \
                        self.index.resolve(mi, ref) != "json.dumps":
                    continue
                kwargs = {kw.arg for kw in node.keywords}
                if None in kwargs:
                    continue  # **kwargs: cannot prove either way
                sk = next((kw.value for kw in node.keywords
                           if kw.arg == "sort_keys"), None)
                bad = "sort_keys" not in kwargs or (
                    isinstance(sk, ast.Constant) and sk.value is False)
                if bad:
                    self._emit(
                        "DET004", mi.path, node.lineno,
                        self._enclosing(mi, node.lineno),
                        "json.dumps without sort_keys=True: dict order "
                        "is insertion order, so two code paths building "
                        "the same mapping serialize differently — every "
                        "dumps on a persisted/canonical path must pin "
                        "key order")

    @staticmethod
    def _enclosing(mi: ModuleInfo, lineno: int) -> str:
        best = ""
        best_span = None
        for fn in mi.functions.values():
            node = fn.node
            end = getattr(node, "end_lineno", None)
            start = getattr(node, "lineno", None)
            if start is None or end is None:
                continue
            if start <= lineno <= end:
                span = end - start
                if best_span is None or span < best_span:
                    best, best_span = fn.qualname, span
        return best
