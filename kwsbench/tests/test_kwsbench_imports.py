"""No run loads JAX or the JAX package, and the reference imports nothing of the port.

Top-level module names are compared whole (the part before the first dot): the port's ``honk_tpu_torch``
begins with the JAX package's ``honk_tpu`` and is not it."""

import ast
import json
import subprocess
import sys

import pytest
from conftest import ROOT, cells, shrink

from kwsbench import harness

# Runs a rehearsal in this process, then prints the top-level names of every module it loaded.
PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from kwsbench import run
code = run.main({argv!r})
print("MODULES " + json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
sys.exit(code)
"""


@pytest.mark.parametrize("workload", cells())
def test_a_run_loads_no_jax_and_no_jax_package(workload):
    argv = ["--workload", workload, "--seed", "2000000031", "--seconds", "0.5", "--device", "cpu",
            "--rehearse", shrink(workload)]
    proc = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), argv=argv)], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env={"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    modules = json.loads(next(line for line in lines if line.startswith("MODULES "))[8:])
    assert "honk_tpu_torch" in modules and "torch" in modules
    assert not set(modules) & set(harness.BANNED_MODULES), sorted(set(modules) & set(harness.BANNED_MODULES))
    result = json.loads(next(line for line in reversed(lines) if line.startswith("{")))
    assert result["correct"] is True


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_port_nor_jax():
    files = sorted((ROOT / "kwsbench" / "reference").glob("*.py"))
    assert files
    for path in files:
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & {"honk_tpu_torch", *harness.BANNED_MODULES}, (path.name, tops)
    # And importing all of it loads none of them.
    modules = ", ".join(f"kwsbench.reference.{path.stem}" for path in files if path.stem != "__init__")
    code = ("import sys; sys.path.insert(0, %r); import %s; "
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}))" % (str(ROOT), modules))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, check=True)
    tops = set(ast.literal_eval(out.stdout.strip()))
    assert not tops & {"honk_tpu_torch", *harness.BANNED_MODULES}


def test_the_drivers_reach_a_family_and_a_recipe_through_the_cell_alone():
    """No driver, ``common.py`` or ``faults.py`` imports a family's or a recipe's module, or names the port's
    classes that the family and the recipe name."""
    import importlib

    from kwsbench.reference import FAMILY, RECIPE

    seam = {}
    for path in (ROOT / "kwsbench" / "reference").glob("*.py"):
        module = importlib.import_module(f"kwsbench.reference.{path.stem}")
        for api, key in ((FAMILY, "PORT_MODEL"), (RECIPE, "PORT_OPTIMIZER")):
            if all(hasattr(module, a) for a in api):
                seam[path.stem] = getattr(module, key).split(":")[1]
    assert {"res", "cnn", "recipe_honk_sgd"} <= set(seam)
    for path in [*(ROOT / "kwsbench" / "drivers").glob("*.py"), ROOT / "kwsbench/common.py",
                 ROOT / "kwsbench/faults.py"]:
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {part for a in node.names for part in a.name.split(".")}
            elif isinstance(node, ast.ImportFrom):
                names |= set((node.module or "").split(".")) | {a.name for a in node.names}
        assert not names & set(seam), (path.name, names & set(seam))
        words = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)} | {
            n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        assert not words & set(seam.values()), (path.name, words & set(seam.values()))


def test_a_banned_module_loaded_stops_the_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(SystemExit) as e:
        harness.emit({"correct": True}, [])
    assert e.value.code != 0
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "honk_tpu_torch_extra", object())  # a name that only begins with one
    assert harness.banned_loaded() == []


def test_without_a_card_a_run_prints_no_result():
    proc = subprocess.run([sys.executable, str(ROOT / "kwsbench" / "run.py"), "--workload", "res8.score.b256",
                           "--seed", "1", "--seconds", "1"], capture_output=True, text=True, timeout=120, cwd=ROOT,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_benchmarks_files_alone_print_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's folder, a run fails: the program is
    not there."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "kwsbench", tmp_path / "kwsbench", ignore=shutil.ignore_patterns("__pycache__"))
    argv = ["--workload", "res8.score.b256", "--seed", "1", "--seconds", "0.5", "--device", "cpu", "--rehearse",
            shrink("res8.score.b256")]
    proc = subprocess.run([sys.executable, "kwsbench/run.py", *argv], capture_output=True, text=True, timeout=120,
                          cwd=tmp_path, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "honk_tpu_torch" in proc.stderr
