"""The port's static analysis (blance_tpu_torch.analysis) against the
reference's, on the CPU.

- Parity: every ASY, RACE, DET and baseline fixture of
  ``tests/test_analysis.py`` goes through the reference's pass and the
  port's copy, which must give equal (rule, line, symbol) lists.
- The eager counterparts: JIT001 / JIT003 / JIT004 over ``DEVICE_ROOTS``
  and DON001-DON004 over ``CONSUMING``, each tripping on a torch-idiom
  fixture while its clean twin does not.
- The tables match reality: every row resolves to a real port function,
  every reference trace root and donating wrapper has its row.
- The gate: the port carries no finding its baseline does not pin and no
  stale pin, and the CLI fails on an injected violation.
"""

import importlib
import inspect
import json
import shutil
import textwrap

import pytest

import blance_tpu_torch.analysis as tanalysis
from blance_tpu_torch.analysis import run_all, run_lints
from blance_tpu_torch.analysis import determinism as tdet
from blance_tpu_torch.analysis import race_lint as trace
from blance_tpu_torch.analysis.donation import CONSUMING, DonationPass
from blance_tpu_torch.analysis.jit_purity import DEVICE_ROOTS, JitPurityPass


def _ref():
    pytest.importorskip("jax")  # the reference package imports it
    return importlib.import_module("blance_tpu.analysis")


def _triples(findings):
    return [(f.rule, f.line, f.symbol) for f in findings]


def _rules(findings):
    return sorted({f.rule for f in findings})


# -- parity of the copied passes ---------------------------------------------

_TOY_SHARED = {"Orchestrator": frozenset({"_flag", "_count", "_items"})}

# (kind, source, options): the snippets of tests/test_analysis.py.
_ASY = {
    "asy101": """
        import asyncio

        async def bad(coro):
            asyncio.ensure_future(coro)

        async def good(coro, tasks):
            t = asyncio.ensure_future(coro)
            tasks.append(t)
            await t
    """,
    "asy102": """
        import asyncio
        import time

        async def bad():
            time.sleep(1.0)

        async def good():
            await asyncio.sleep(1.0)

        def sync_ok():
            time.sleep(0.1)
    """,
    "asy103_trips": """
        def bad():
            try:
                work()
            except Exception:
                return False
            return True
    """,
    "asy103_clean": """
        import logging

        def uses_exc():
            try:
                work()
            except Exception as e:
                logging.warning("failed: %s", e)
                return False
            return True

        def reraises():
            try:
                work()
            except Exception:
                cleanup()
                raise

        def narrow():
            try:
                work()
            except ValueError:
                return False
    """,
    "asy104_trips": """
        class O:
            async def run(self, node):
                result = self._assign_partitions(node)
                return await result
    """,
    "asy104_clean": """
        import asyncio

        class O:
            async def run(self, node):
                result = self._assign_partitions(node)
                return await asyncio.wait_for(result, 5.0)
    """,
}

_RACE = {
    "race001_rmw": """
        class Orchestrator:
            async def bump(self):
                tmp = self._count
                await self._notify()
                self._count = tmp + 1
    """,
    "race001_augassign_await": """
        class Orchestrator:
            async def bump(self):
                self._count += await self._notify()
    """,
    "race001_augassign_clean": """
        class Orchestrator:
            async def bump(self):
                self._count += 1
                await self._notify()
    """,
    "race001_atomic": """
        class Orchestrator:
            async def bump(self):
                tmp = self._count
                self._count = tmp + 1
                await self._notify()
    """,
    "race002_stale_guard": """
        class Orchestrator:
            async def run(self):
                flag = self._flag
                await self._notify()
                if flag is not None:
                    await flag.get()
    """,
    "race002_revalidation": """
        class Orchestrator:
            async def run(self):
                await self._notify()
                while True:
                    flag = self._flag
                    if flag is None:
                        break
                    await flag.get()
    """,
    "race002_use_before_await": """
        class Orchestrator:
            async def run(self):
                flag = self._flag
                if flag is not None:
                    await flag.get()
    """,
    "race002_untracked": """
        class Orchestrator:
            async def run(self):
                opts = self.options
                await self._notify()
                return opts.timeout
    """,
    "race003_multi_root": """
        import asyncio

        class Orchestrator:
            def start(self):
                self._spawn(self._worker_a())
                self._spawn(self._worker_b())

            def _spawn(self, coro):
                return asyncio.ensure_future(coro)

            async def _worker_a(self):
                self._items.append(1)
                await self._notify()

            async def _worker_b(self):
                self._items.append(2)
                await self._notify()
    """,
    "race003_subscript": """
        import asyncio

        class Orchestrator:
            def start(self):
                self._spawn(self._worker_a())
                self._spawn(self._worker_b())

            def _spawn(self, coro):
                return asyncio.ensure_future(coro)

            async def _worker_a(self):
                self._items["a"] = 1
                await self._notify()

            async def _worker_b(self):
                del self._items["b"]
                await self._notify()
    """,
    "race003_single_root": """
        import asyncio

        class Orchestrator:
            def start(self):
                self._spawn(self._worker())

            def _spawn(self, coro):
                return asyncio.ensure_future(coro)

            async def _worker(self):
                self._items.append(1)
                await self._notify()
                self._helper()

            def _helper(self):
                self._items.append(2)
    """,
    "race003_no_task_owner": """
        class Orchestrator:
            def a(self):
                self._items.append(1)

            def b(self):
                self._items.append(2)
    """,
    "race_unmodeled_class": """
        class Whatever:
            async def run(self):
                flag = self._flag
                await self._notify()
                return flag
    """,
}

_DET = {
    "det001_wall_clock": ("""
        import time

        def f():
            return time.monotonic()
    """, {}),
    "det001_loop_time": ("""
        def f(loop):
            return loop.time() + 1.0
    """, {}),
    "det001_seam": ("""
        import time

        def f():
            return time.perf_counter()
    """, {"clock_seams": {"mod.f": "the declared boundary"}}),
    "det001_injected_default": ("""
        import time

        def f(clock=time.monotonic):
            return clock()
    """, {}),
    "det002_unseeded": ("""
        import random
        import uuid

        def f():
            return random.random(), uuid.uuid4(), random.Random()
    """, {}),
    "det002_numpy": ("""
        import numpy as np

        def f(n):
            return np.random.rand(n)
    """, {}),
    "det002_seeded": ("""
        import random

        def f(seed):
            rng = random.Random(seed)
            return rng.random()
    """, {}),
    "det003_set_sink": ("""
        def canonical_log_text(events):
            return str(events)

        def f(xs):
            pending = set(xs)
            return canonical_log_text(pending)
    """, {}),
    "det003_through_list": ("""
        def canonical_log_text(events):
            return str(events)

        def f(xs):
            pending = set(xs)
            items = list(pending)
            return canonical_log_text(items)
    """, {}),
    "det003_sorted": ("""
        def canonical_log_text(events):
            return str(events)

        def f(xs):
            pending = set(xs)
            return canonical_log_text(sorted(pending))
    """, {}),
    "det004_unsorted_dumps": ("""
        import json

        def f(d):
            return json.dumps(d)
    """, {}),
    "det004_sorted_and_passthrough": ("""
        import json

        def f(d):
            return json.dumps(d, sort_keys=True)

        def g(d, sort_keys):
            return json.dumps(d, sort_keys=sort_keys)
    """, {}),
    "det005_hash_order": ("""
        def f(xs):
            xs.sort(key=lambda x: hash(x))
            return sorted(xs, key=lambda x: (id(x), x))
    """, {}),
    "det005_field_key": ("""
        def f(xs, h):
            keep = id(xs)  # identity use outside ordering is fine
            h[keep] = True
            return sorted(xs, key=lambda x: x.name)
    """, {}),
    "det006_env": ("""
        import os

        def f():
            return os.environ.get("KNOB", "1"), os.environ["OTHER"]

        def g():
            return os.getenv("THIRD")
    """, {}),
    "det006_declared_knob": ("""
        import os

        def f():
            return os.environ.get("KNOB", "1")
    """, {"config_knobs": {"mod.f": "KNOB: fixture"}}),
    "det_unreached": ("""
        import time

        def f():
            return time.monotonic()
    """, {"roots": {"other_module": "not this one"}}),
}


def _findings_for(pkg, kind, case, tmp_path):
    if kind == "asy":
        mod = importlib.import_module(f"{pkg}.asyncio_lint")
        return mod.lint_source(textwrap.dedent(_ASY[case]), "/r/mod.py",
                               "/r")
    if kind == "race":
        mod = importlib.import_module(f"{pkg}.race_lint")
        return mod.lint_source(textwrap.dedent(_RACE[case]), "/r/mod.py",
                               "/r", shared_state=_TOY_SHARED)
    source, opts = _DET[case]
    mod = importlib.import_module(f"{pkg}.determinism")
    f = tmp_path / "mod.py"
    f.write_text(textwrap.dedent(source))
    roots = opts.get("roots")
    return mod.DeterminismPass(
        [str(f)], repo_root=str(tmp_path),
        replay_roots={"mod": "fixture"} if roots is None else roots,
        clock_seams=opts.get("clock_seams") or {},
        serialized_sinks=None,
        config_knobs=opts.get("config_knobs") or {},
    ).run()


def _baseline_case(pkg, case):
    """One of the reference's baseline fixtures through ``pkg``'s
    Baseline: its outcome as plain data (or the error it raised)."""
    base = importlib.import_module(f"{pkg}.baseline")
    finding_cls = importlib.import_module(pkg).Finding

    def fnd(rule="ASY103", path="pkg/m.py", line=10, symbol="f"):
        return finding_cls(rule=rule, path=path, line=line, symbol=symbol,
                           message="msg")

    def entries(es):
        return [(e.rule, e.path, e.symbol, e.line, e.reason) for e in es]

    def raised(fn, *args):
        try:
            fn(*args)
        except ValueError as e:
            return ("ValueError", str(e))
        return None

    if case == "match_symbol":
        b = base.Baseline([base.BaselineEntry(
            rule="ASY103", path="pkg/m.py", symbol="f", reason="why")])
        new, accepted = b.split([fnd(), fnd(symbol="g")])
        return (_triples(new), [(_triples([f]), r) for f, r in accepted],
                entries(b.unused()))
    if case == "line_pin_and_stale":
        b = base.Baseline([
            base.BaselineEntry(rule="ASY103", path="pkg/m.py", line=10,
                               reason="pinned"),
            base.BaselineEntry(rule="JIT001", path="pkg/other.py",
                               reason="stale")])
        new, accepted = b.split([fnd(line=10), fnd(line=11)])
        return (_triples(new), [(_triples([f]), r) for f, r in accepted],
                entries(b.unused()))
    if case == "toml_roundtrip":
        return entries(base.parse_toml_findings(textwrap.dedent("""
            # comment
            [[finding]]
            rule = "ASY103"
            path = "pkg/m.py"  # trailing comment
            symbol = "f"
            line = 12
            reason = "a \\"quoted\\" reason"
        """)))
    if case == "toml_errors":
        return [raised(base.parse_toml_findings, text) for text in (
            '[[finding]]\nrule = "X"\npath = "p"\n',
            '[[finding]]\nrule = "X"\npath = "p"\nreason = "r"\n'
            'bogus = "v"\n',
            'rule = "X"\n')]
    if case == "subset_parser":
        return [raised(base._parse_subset, text, "<t>") for text in (
            '[[finding]]\nrule = [1]\n', 'rule = "X"\n',
            '[[finding]]\njunk\n')] + [entries(base._parse_subset(
                '[[finding]]\nrule = "R"\npath = "p"\nreason = "r"\n'
                'line = 3\n', "<t>"))]
    raise KeyError(case)


_BASELINE = ["match_symbol", "line_pin_and_stale", "toml_roundtrip",
             "toml_errors", "subset_parser"]

_PARITY = ([("asy", c) for c in _ASY] + [("race", c) for c in _RACE]
           + [("det", c) for c in _DET] + [("baseline", c) for c in _BASELINE])


@pytest.mark.parametrize("kind,case", _PARITY,
                         ids=[f"{k}-{c}" for k, c in _PARITY])
def test_copied_passes_match_the_reference(kind, case, tmp_path):
    """The port's copy of each pass gives the reference's (rule, line,
    symbol) list on every ASY, RACE, DET and baseline fixture."""
    _ref()
    if kind == "baseline":
        want = _baseline_case("blance_tpu.analysis", case)
        got = _baseline_case("blance_tpu_torch.analysis", case)
        assert got == want
        return
    for sub in ("ref", "port"):
        (tmp_path / sub).mkdir()
    want = _triples(_findings_for("blance_tpu.analysis", kind, case,
                                  tmp_path / "ref"))
    got = _triples(_findings_for("blance_tpu_torch.analysis", kind, case,
                                 tmp_path / "port"))
    assert got == want


# -- device roots: JIT001 / JIT003 / JIT004 on torch idioms ------------------


def _jit(tmp_path, source, roots=("mod.f",)):
    f = tmp_path / "mod.py"
    f.write_text(textwrap.dedent(source))
    return JitPurityPass([str(f)], repo_root=str(tmp_path),
                         device_roots={r: "fixture" for r in roots}).run()


def test_jit001_torch_global_generator_trips(tmp_path):
    fs = _jit(tmp_path, """
        import torch

        def f(x):
            return x + torch.rand(x.shape, device=x.device)
    """)
    assert _rules(fs) == ["JIT001"]
    assert fs[0].symbol == "f" and "generator" in fs[0].message


def test_jit001_seeded_generator_is_clean(tmp_path):
    fs = _jit(tmp_path, """
        import torch

        def f(x, gen: torch.Generator):
            return x + torch.rand(x.shape, generator=gen)
    """)
    assert fs == []


def test_jit001_reached_helper_trips_unreached_is_clean(tmp_path):
    fs = _jit(tmp_path, """
        import time

        def helper(x):
            return x * time.perf_counter()

        def host_wrapper(x):
            t0 = time.perf_counter()
            return f(x), time.perf_counter() - t0

        def f(x):
            return helper(x)
    """)
    assert _triples(fs) == [("JIT001", 5, "helper")]


def test_jit003_item_in_a_root_trips(tmp_path):
    fs = _jit(tmp_path, """
        def f(x):
            return x * x.sum().item()
    """)
    assert _rules(fs) == ["JIT003"]
    assert ".item()" in fs[0].message


def test_jit003_branch_coercion_and_host_copy_trip(tmp_path):
    fs = _jit(tmp_path, """
        import torch

        def f(x, k: int):
            changed = (x > 0).any()
            if changed:
                x = x + 1
            while bool((x < k).all()):
                x = x * 2
            return float(x.max()), x.cpu()
    """)
    assert _triples(fs) == [("JIT003", 6, "f"), ("JIT003", 8, "f"),
                            ("JIT003", 10, "f"), ("JIT003", 10, "f")]


def test_jit003_host_facts_are_clean(tmp_path):
    fs = _jit(tmp_path, """
        import torch

        def f(x, carry=None, k: int = 2):
            n = int(x.shape[0])
            if carry is not None and x.dim() == 2 and len(x) > k:
                x = x + carry
            if k > 1 and x.numel():
                x = x[:n]
            return x
    """)
    assert fs == []


def test_jit003_follows_tensors_into_helpers(tmp_path):
    # A helper's unannotated parameter is a tensor when a reached call
    # site passes it one; a host value passed the same way is not.
    fs = _jit(tmp_path, """
        def helper(v, n):
            if n > 3:
                return v
            return int(v.sum())

        def f(x, k: int):
            return helper(x, k)
    """)
    assert _triples(fs) == [("JIT003", 5, "helper")]


def test_jit003_annotated_host_parameters_are_clean(tmp_path):
    # constraints handed to ``constraints: tuple`` is a host value in
    # the root too.
    fs = _jit(tmp_path, """
        def solve(x, constraints: tuple):
            return x

        def f(x, constraints):
            if constraints:
                x = solve(x, constraints)
            return x
    """)
    assert fs == []


def test_jit004_captured_mutation_trips_local_is_clean(tmp_path):
    fs = _jit(tmp_path, """
        _SEEN = []
        _HANDLE = None

        def f(x):
            global _HANDLE
            _SEEN.append(1)
            local = []
            local.append(x)
            return x
    """)
    assert _triples(fs) == [("JIT004", 6, "f"), ("JIT004", 7, "f")]


# -- the consumption contract: DON001-DON004 on the warm carry --------------

_DON_PRELUDE = """
    import numpy as np
    import torch


    def _warm_repair(prev, pweights, carry_used, constraints):
        return prev, carry_used
"""


def _don(tmp_path, source):
    f = tmp_path / "fix.py"
    f.write_text(textwrap.dedent(_DON_PRELUDE) + textwrap.dedent(source))
    return DonationPass([str(f)], repo_root=str(tmp_path),
                        consuming={"fix._warm_repair": ("carry_used",)}
                        ).run()


def test_don001_fallback_rereads_the_consumed_carry_trips(tmp_path):
    # The reference's first DON001 fixture (tests/test_analysis.py, the
    # exhaustion fallback re-reading a donated operand) spelled on the
    # port's warm carry: the fallback re-reads the consumed carry.
    fs = _don(tmp_path, """
        def warm(prev, pweights, carry, fallback):
            used = carry.used.to(prev.device)
            out, new_used = _warm_repair(prev, pweights, used,
                                         constraints=(2,))
            return fallback(out.cpu().numpy(), carry.used, pweights)
    """)
    assert _rules(fs) == ["DON001"]
    assert fs[0].symbol == "warm" and "carry.used" in fs[0].message


def test_don001_clean_snapshot_twin(tmp_path):
    fs = _don(tmp_path, """
        def warm(prev, pweights, carry, fallback):
            keep = carry.used.clone()
            out, new_used = _warm_repair(prev, pweights,
                                         carry.used.to(prev.device),
                                         constraints=(2,))
            return fallback(out, keep, pweights), new_used.shape
    """)
    assert fs == []


def test_don001_returning_consumed_operand_trips(tmp_path):
    fs = _don(tmp_path, """
        def warm(prev, pweights, used):
            out, new_used = _warm_repair(prev, pweights,
                                         torch.as_tensor(used),
                                         constraints=(2,))
            return used
    """)
    assert _rules(fs) == ["DON001"]


def test_don002_escape_before_the_call_trips(tmp_path):
    fs = _don(tmp_path, """
        class Session:
            def warm(self, prev, pweights, carry):
                self._cache.store("k", carry.used)
                out, new_used = _warm_repair(prev, pweights, carry.used,
                                             constraints=(2,))
                return out
    """)
    assert _rules(fs) == ["DON002"]


def test_don002_storing_the_output_is_clean(tmp_path):
    fs = _don(tmp_path, """
        class Session:
            def warm(self, prev, pweights, carry):
                out, new_used = _warm_repair(prev, pweights, carry.used,
                                             constraints=(2,))
                self._cache.store("k", new_used)
                return out
    """)
    assert fs == []


def test_don003_second_call_without_rebinding_trips(tmp_path):
    fs = _don(tmp_path, """
        def warm(prev, pweights, used):
            out, _u = _warm_repair(prev, pweights, used, constraints=(2,))
            out2, _u2 = _warm_repair(out, pweights, used, constraints=(2,))
            return out2
    """)
    assert _rules(fs) == ["DON003"]


def test_don003_rebound_second_call_is_clean(tmp_path):
    fs = _don(tmp_path, """
        def warm(prev, pweights, used):
            out, used = _warm_repair(prev, pweights, used, constraints=(2,))
            out2, used = _warm_repair(out, pweights, used, constraints=(2,))
            return out2, used
    """)
    assert fs == []


def test_don004_snapshot_after_the_call_trips(tmp_path):
    fs = _don(tmp_path, """
        def warm(prev, pweights, used):
            out, new_used = _warm_repair(prev, pweights, used,
                                         constraints=(2,))
            keep = used.clone()
            return out, keep
    """)
    assert _rules(fs) == ["DON004"]


# -- the tables match reality ------------------------------------------------


def _resolve(fq):
    parts = fq.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:cut]))
        except ImportError:
            continue
        try:
            for attr in parts[cut:]:
                obj = getattr(obj, attr)
        except AttributeError:
            return None
        return obj
    return None


@pytest.mark.parametrize("table", ["DEVICE_ROOTS", "CONSUMING"])
def test_root_and_consuming_rows_resolve_to_port_functions(table):
    rows = DEVICE_ROOTS if table == "DEVICE_ROOTS" else CONSUMING
    assert rows
    for fq, value in rows.items():
        assert fq.startswith("blance_tpu_torch."), fq
        fn = _resolve(fq)
        assert inspect.isfunction(fn), f"{table} row {fq!r} is no function"
        if table == "CONSUMING":
            params = inspect.signature(fn).parameters
            assert value and all(p in params for p in value), (fq, value)
        else:
            assert value.strip(), f"{fq} has no reason"


# A reference trace root whose port counterpart has another name.
_ROOT_RENAMES = {
    # the reference jits the carry table's build on its own
    "blance_tpu.plan.tensor._carry_used_jit":
        "blance_tpu_torch.plan.tensor.carry_from_assignment",
    # the reference jits the public wrapper's body; the port's public
    # wrapper is host recording around the impl
    "blance_tpu.plan.tensor.solve_dense_converged":
        "blance_tpu_torch.plan.tensor._solve_dense_converged_impl",
}


def test_every_reference_trace_root_has_a_device_root():
    ref = _ref()
    from blance_tpu.analysis.jit_purity import JitPurityPass as RefPass

    p = RefPass(ref._iter_py_files([ref.PACKAGE_ROOT]), ref.REPO_ROOT)
    p._find_roots()
    roots = sorted(fn.fq for mi in p.modules.values()
                   for fn in mi.functions.values() if fn.is_root)
    assert len(roots) >= 15
    for fq in roots:
        port = _ROOT_RENAMES.get(
            fq, "blance_tpu_torch." + fq[len("blance_tpu."):])
        assert port in DEVICE_ROOTS, (fq, port)


def test_every_reference_donating_wrapper_has_a_consuming_row():
    ref = _ref()
    from blance_tpu.analysis.donation import DonationPass as RefPass

    p = RefPass(ref._iter_py_files([ref.PACKAGE_ROOT]), ref.REPO_ROOT)
    p.run()
    assert len(p.registry) >= 5
    for dc in p.registry.values():
        port = "blance_tpu_torch." + dc.fq[len("blance_tpu."):]
        # prev is the one listed exception: the port re-reads it after
        # the solve by design (donation.CONSUMING's comment).
        want = tuple(x for x in dc.donated if x != "prev")
        if want:
            assert CONSUMING.get(port) == want, (dc.fq, port)
        else:
            assert port not in CONSUMING, port


def test_race_lint_model_names_real_port_attributes():
    """SHARED_STATE keys on class names the port's copies carry; every
    attribute it names still appears in the port class's source."""
    from blance_tpu_torch import control, fleetloop
    from blance_tpu_torch.durability import epoch, journal
    from blance_tpu_torch.obs import costmodel, slo
    from blance_tpu_torch.orchestrate import csp, health, orchestrator
    from blance_tpu_torch.orchestrate.sched import policy
    from blance_tpu_torch.plan import carry, service

    rebalance = importlib.import_module("blance_tpu_torch.rebalance")
    classes = {
        "CycleEngine": control.CycleEngine,
        "FleetController": fleetloop.FleetController,
        "FleetSloRollup": slo.FleetSloRollup,
        "Orchestrator": orchestrator.Orchestrator,
        "OrchestratorProgress": orchestrator.OrchestratorProgress,
        "HealthTracker": health.HealthTracker,
        "NodeHealth": health.NodeHealth,
        "Chan": csp.Chan,
        "NextMoves": orchestrator.NextMoves,
        "SloTracker": slo.SloTracker,
        "CostModel": costmodel.CostModel,
        "PlanService": service.PlanService,
        "CarryCache": carry.CarryCache,
        "EncodeCache": carry.EncodeCache,
        "RebalanceController": rebalance.RebalanceController,
        "_CriticalPathBound": policy._CriticalPathBound,
        "Journal": journal.Journal,
        "EpochFence": epoch.EpochFence,
    }
    assert set(trace.SHARED_STATE) == set(classes)
    for cls, attrs in trace.SHARED_STATE.items():
        src = inspect.getsource(classes[cls])
        for attr in attrs:
            assert attr.split(".")[0] in src, (cls, attr)


def test_determinism_tables_match_reality():
    for name, table in [("REPLAY_ROOTS", tdet.REPLAY_ROOTS),
                        ("CLOCK_SEAMS", tdet.CLOCK_SEAMS),
                        ("CONFIG_KNOBS", tdet.CONFIG_KNOBS)]:
        for fq, reason in table.items():
            assert fq.startswith("blance_tpu_torch."), (name, fq)
            assert reason.strip(), f"{name}[{fq!r}] has no reason"
            assert _resolve(fq) is not None, (name, fq)
    # Each knob is a function that reads the environment.
    for fq in tdet.CONFIG_KNOBS:
        assert "os.environ" in inspect.getsource(_resolve(fq)), fq
    representatives = {
        "journal.append": "blance_tpu_torch.durability.journal.Journal.append",
        "canonical_log_text":
            "blance_tpu_torch.testing.simulate.canonical_log_text",
        "canonical_fleet_log_text":
            "blance_tpu_torch.testing.fleetsim.canonical_fleet_log_text",
        "crash_log_text": "blance_tpu_torch.testing.crashsim.crash_log_text",
        "render_prometheus": "blance_tpu_torch.obs.expo.render_prometheus",
        "atomic_write_json":
            "blance_tpu_torch.utils.atomicio.atomic_write_json",
        "atomic_write_text":
            "blance_tpu_torch.utils.atomicio.atomic_write_text",
    }
    assert set(representatives) == set(tdet.SERIALIZED_SINKS)
    for sink, fq in representatives.items():
        assert _resolve(fq) is not None, (sink, fq)


def test_every_config_knob_is_one_the_pass_reports():
    """Without CONFIG_KNOBS the pass reports DET006 in exactly the
    declared knob functions: no row is dead, none is missing."""
    files = tanalysis._iter_py_files([tanalysis.PACKAGE_ROOT])
    found = tdet.DeterminismPass(files, tanalysis.REPO_ROOT,
                                 config_knobs={}).run()
    assert {f.rule for f in found} == {"DET006"}
    hit = {f"blance_tpu_torch.{f.path[len('blance_tpu_torch/'):-3]}"
           .replace("/", ".") + "." + f.symbol for f in found}
    assert hit == set(tdet.CONFIG_KNOBS)


def test_determinism_and_donation_real_package_are_clean():
    files = tanalysis._iter_py_files([tanalysis.PACKAGE_ROOT])
    for cls in (tdet.DeterminismPass, DonationPass):
        findings = cls(files, tanalysis.REPO_ROOT).run()
        assert findings == [], "\n".join(f.render() for f in findings)


def test_device_roots_reach_the_kernel_wrappers():
    """The roots' call graph reaches every kernel wrapper and the
    solver's helpers (a resolver regression would shrink it)."""
    p = JitPurityPass(tanalysis._iter_py_files([tanalysis.PACKAGE_ROOT]),
                      tanalysis.REPO_ROOT)
    reached = {fn.fq for fn in p._reachable()}
    assert len(reached) >= 60
    for fq in ("blance_tpu_torch.plan.tensor._assign_slot",
               "blance_tpu_torch.plan.tensor._run_auction",
               "blance_tpu_torch.ops.reduce2._launch",
               "blance_tpu_torch.ops.sparse2.sparse_priced_min2_cand"):
        assert fq in reached, fq


# -- the gate ----------------------------------------------------------------


def test_port_has_zero_nonbaselined_findings():
    result = run_all(shape_audit=False)
    assert result.errors == []
    rendered = "\n".join(f.render() for f in result.new)
    assert result.new == [], f"non-baselined findings:\n{rendered}"
    stale = [e.render() for e in result.unused_baseline]
    assert stale == [], f"stale baseline entries: {stale}"
    # The JIT003 pins are the deliberate syncs, one line each.
    syncs = [f for f, _r in result.baselined if f.rule == "JIT003"]
    assert len(syncs) >= 10


def test_lints_cover_the_port(tmp_path):
    # The port's module count only grows; a collapse here means the
    # walker lost a directory.  run_lints counts what it walked.
    assert len(tanalysis._iter_py_files([tanalysis.PACKAGE_ROOT])) >= 60
    one = tmp_path / "one.py"
    one.write_text("x = 1\n")
    assert run_lints([str(one)]) == ([], 1)


def _package_copy(tmp_path, monkeypatch, edit=None):
    """The port's package copied under ``tmp_path`` (the repo root the
    findings are relative to), with ``edit(path -> text)`` applied."""
    root = tmp_path / "repo"
    shutil.copytree(tanalysis.PACKAGE_ROOT, root / "blance_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build",
                                                  "_native_build", "*.so"))
    for rel, (old, new) in (edit or {}).items():
        path = root / "blance_tpu_torch" / rel
        text = path.read_text()
        assert text.count(old) == 1, (rel, old)
        path.write_text(text.replace(old, new))
    monkeypatch.setattr(tanalysis, "REPO_ROOT", str(root))
    return str(root / "blance_tpu_torch")


def test_cli_fails_on_wall_clock_in_a_device_root(tmp_path, monkeypatch,
                                                  capsys):
    from blance_tpu_torch.analysis.__main__ import main

    clean = _package_copy(tmp_path / "a", monkeypatch)
    assert main([clean]) == 0
    assert "0 new finding(s)" in capsys.readouterr().out
    # Same line count, so every line pin still matches.
    bad = _package_copy(tmp_path / "b", monkeypatch, {
        "plan/tensor.py": (
            '    """Solve the whole placement problem once; returns',
            '    time.time(); """Solve the whole placement problem once; '
            'returns')})
    assert main([bad]) == 1
    out = capsys.readouterr().out
    assert "JIT001 [solve_dense]" in out and "FAIL" in out


def test_cli_determinism_mode_fails_on_unsorted_dumps(tmp_path, monkeypatch,
                                                      capsys):
    from blance_tpu_torch.analysis.__main__ import main

    bad = _package_copy(tmp_path, monkeypatch, {
        "testing/simulate.py": (
            "def canonical_log_text(events: list[dict[str, Any]]) -> str:\n",
            "def canonical_log_text(events: list[dict[str, Any]]) -> str:"
            "  # noqa\n    json.dumps(events)\n")})
    assert main(["--determinism", bad]) == 1
    out = capsys.readouterr().out
    assert "DET004 [canonical_log_text]" in out
    assert "stale baseline entry" not in out


@pytest.mark.parametrize("mode", ["--determinism", "--donation"])
def test_cli_single_pass_modes_are_clean(mode, capsys):
    from blance_tpu_torch.analysis.__main__ import main

    assert main([mode]) == 0
    out = capsys.readouterr().out
    assert "0 new finding(s)" in out
    # The other passes' pins are unused by construction, not stale.
    assert "stale baseline entry" not in out


def test_cli_donation_mode_catches_the_warm_carry_regression(tmp_path,
                                                             monkeypatch,
                                                             capsys):
    from blance_tpu_torch.analysis.__main__ import main

    # solve_dense_warm handing the consumed carry's table back out.
    bad = _package_copy(tmp_path, monkeypatch, {
        "plan/tensor.py": (
            "    return out.cpu().numpy(), SolveCarry(prices=new_used.sum(0), "
            "assign=out,\n                                         "
            "used=new_used)",
            "    return out.cpu().numpy(), SolveCarry(prices=new_used.sum(0), "
            "assign=out,\n                                         "
            "used=used)")})
    assert main(["--donation", bad]) == 1
    assert "DON001 [solve_dense_warm]" in capsys.readouterr().out


def test_cli_json_output(tmp_path, capsys):
    from blance_tpu_torch.analysis.__main__ import main

    bad = tmp_path / "violation.py"
    bad.write_text(
        "import asyncio\n\nasync def f(c):\n"
        "    asyncio.ensure_future(c)\n")
    rc = main(["--json", str(bad)])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload["pass"] is False
    assert [f["rule"] for f in payload["new"]] == ["ASY101"]


def test_cli_stale_baseline_warns_by_default_fails_under_ci(tmp_path,
                                                            capsys,
                                                            monkeypatch):
    """A pin matching nothing is a warning in the editor loop and a hard
    error under --ci (here with the checks that run on a device on the
    CPU; the build-budget workload is stubbed, as the reference's test
    stubs it)."""
    from blance_tpu_torch.analysis import retrace
    from blance_tpu_torch.analysis.__main__ import main

    monkeypatch.setattr(retrace, "_workload", lambda device, repeat: None)
    clean = tmp_path / "clean.py"
    clean.write_text("def f(x):\n    return x\n")
    stale = tmp_path / "baseline.toml"
    stale.write_text('[[finding]]\nrule = "JIT001"\npath = "gone.py"\n'
                     'reason = "fixed long ago"\n')
    assert main([str(clean), "--baseline", str(stale)]) == 0
    assert "warning: stale baseline entry" in capsys.readouterr().out
    rc = main([str(clean), "--baseline", str(stale), "--ci",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "ERROR: stale baseline entry" in out and "FAIL" in out
    assert "72 shape contracts + 4 host checks" in out


def test_cli_device_defaults_to_the_card(monkeypatch, capsys):
    """--shape-audit without --device targets the card; with no card
    the audit crash is reported and the run fails, never falling back to
    the CPU."""
    import torch

    from blance_tpu_torch.analysis.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--shape-audit", "--no-baseline",
                 tanalysis.PACKAGE_ROOT + "/utils/hostclock.py"]) == 1
    out = capsys.readouterr().out
    assert "shape audit crashed" in out and "is_available" in out
