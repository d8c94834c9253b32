"""The port stands alone: no jax, no blance_tpu, and no silent CPU run.

blance_tpu_torch must run on a machine that has PyTorch and no jax, so
neither the package nor chip_smoke.py may import jax or anything of the
JAX package, and an entry point asked for the card must not quietly run
on the CPU instead.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "blance_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'blance_tpu' or "
        "m.startswith('blance_tpu.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_no_jax_or_reference_import_in_port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, fs in os.walk(PKG):
        files += [os.path.join(dirpath, f) for f in fs if f.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "blance_tpu"), (path, name)


def test_cuda_default_raises_without_gpu(monkeypatch):
    """Called without ``device=``, the entry point targets the card; with
    no card it raises rather than running on the CPU."""
    import blance_tpu_torch as bt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parts = {str(i): bt.Partition(str(i), {}) for i in range(8)}
    with pytest.raises(RuntimeError, match="is_available"):
        bt.plan_next_map(parts, parts, ["a", "b", "c"], [], [],
                         bt.model(primary=(0, 1)), backend="cuda")


@pytest.mark.parametrize("spec", [
    dict(node_scorer=lambda ctx, node: 0.0),
    dict(node_sorter=lambda ctx, nodes: nodes),
    dict(node_score_booster=lambda w, s: 0.0),
    dict(node_weights={"a": -1}),
    dict(shape_bucketing=True),
])
def test_unported_options_raise(spec):
    """The options that once raised NotImplementedError (hooks, a
    non-cbgt booster, negative weights without it: the exact path;
    shape_bucketing: the padded solve) now plan, on the CPU, exactly as
    the reference's backend="tpu" does."""
    import blance_tpu_torch as bt

    pytest.importorskip("jax")  # the reference needs it
    import blance_tpu

    out = []
    for lib, kw in ((bt, dict(device="cpu")),
                    (blance_tpu, dict(backend="tpu"))):
        parts = {str(i): lib.Partition(str(i), {}) for i in range(8)}
        m, w = lib.plan_next_map(parts, parts, ["a", "b", "c"], [], [],
                                 lib.model(primary=(0, 1)),
                                 lib.PlanOptions(**spec), **kw)
        out.append(({k: p.nodes_by_state for k, p in m.items()}, w))
    assert out[0] == out[1]


def test_port_exports_the_reference_surface():
    """Every name the reference exports is exported by the port; each
    export resolves."""
    import blance_tpu_torch as bt

    jax = pytest.importorskip("jax")  # noqa: F841 (the reference needs it)
    import blance_tpu

    missing = set(blance_tpu.__all__) - set(bt.__all__)
    assert not missing, sorted(missing)
    assert all(hasattr(bt, name) for name in bt.__all__)


def test_cbgt_booster_and_sparse_none_plan_on_cpu():
    """The cbgt booster with negative weights is supported, and
    sparse=None resolves to the dense engine."""
    import blance_tpu_torch as bt

    parts = {str(i): bt.Partition(str(i), {}) for i in range(12)}
    opts = bt.PlanOptions(node_weights={"a": -1},
                          node_score_booster=bt.cbgt_node_score_booster,
                          sparse=None)
    out, warn = bt.plan_next_map(parts, parts, ["a", "b", "c"], [], [],
                                 bt.model(primary=(0, 1)), opts,
                                 backend="auto", device="cpu")
    assert not warn
    assert all(len(p.nodes_by_state["primary"]) == 1 for p in out.values())


FLEET_MODULES = ["plan.fleet", "plan.service", "plan.resident", "plan.carry",
                 "fleetloop", "durability", "durability.journal",
                 "durability.recover", "obs.tracectx", "core.encode"]


@pytest.mark.parametrize("mod", FLEET_MODULES)
def test_fleet_tier_modules_export_the_reference_surface(mod):
    """The fleet tier's modules are in the port, import without jax (the
    subprocess check above walks them), and export every name their
    reference module exports."""
    import importlib

    assert f"blance_tpu_torch.{mod}" in _port_modules()
    port = importlib.import_module(f"blance_tpu_torch.{mod}")
    pytest.importorskip("jax")  # the reference needs it
    ref = importlib.import_module(f"blance_tpu.{mod}")
    missing = set(getattr(ref, "__all__", ())) - set(port.__all__)
    assert not missing, sorted(missing)


OBS_MODULES = ["obs", "obs.device", "obs.device_check", "obs.chrome",
               "obs.expo", "obs.__main__", "utils.trace", "analysis",
               "analysis.retrace", "analysis.membudget"]


@pytest.mark.parametrize("mod", OBS_MODULES)
def test_observatory_modules_export_the_reference_surface(mod):
    """The observatory's modules are in the port and import without jax
    (the subprocess check above walks them); each exports every name its
    reference module exports, but for the analysis package, which holds
    only Finding (its lints and run_all are ROADMAP A.16)."""
    import importlib

    assert f"blance_tpu_torch.{mod}" in _port_modules()
    port = importlib.import_module(f"blance_tpu_torch.{mod}")
    pytest.importorskip("jax")  # the reference needs it
    ref = importlib.import_module(f"blance_tpu.{mod}")
    want = set(getattr(ref, "__all__", ()))
    if mod == "analysis":
        want = {"Finding"}
    missing = want - set(getattr(port, "__all__", ()))
    assert not missing, sorted(missing)
