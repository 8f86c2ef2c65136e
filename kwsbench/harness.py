"""What every run shares: finding its cell, configuration, traffic, limits, model family, recipe and metrics by
name; the card and module checks; the result line.

``BENCHMARK.json`` at the checkout's root names everything. A cell's entry
there gives its configuration (whose ``file`` is the sizes as run, and
whose ``family`` names the family's reference module
``kwsbench/reference/<family>.py``), its traffic
(``kwsbench/traffic/<traffic>.json``, whose ``kind`` names the driver
``kwsbench/drivers/<kind>.py``; where the driver ``NEEDS`` a ``recipe``,
it names ``kwsbench/reference/recipe_<recipe>.py``) and its chips; its
limits are ``kwsbench/limits/<cell>.json``; each per-layer metric is a
reader, ``kwsbench/metrics/<metric>.py``, or, where there is none, the
reader of the part of its name before the first dot (``mfu.train`` and
``mfu.score`` both read ``mfu.py``). So a cell, a configuration, a model
family, a traffic mix, a recipe or a metric is added by adding files, and
no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys
from pathlib import Path
from types import ModuleType

from .reference import FAMILY, RECIPE

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = Path(__file__).resolve().parent / "reference"
# Top-level module names that no run may load: JAX and the JAX package the port was made from.
BANNED_MODULES = ("jax", "jaxlib", "flax", "honk_tpu")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json``, with everything found for it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    family: ModuleType  # the configuration's ``family``
    recipe: ModuleType | None  # the traffic's ``recipe``, where its driver needs one


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, reported: set[str] | None = None) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed in its ``workloads``, or the metric lists none (an
    end-to-end metric: every cell; a per-layer one: every cell that reports the metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"kwsbench: no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root / conf["file"])
    traffic_file = f"kwsbench/traffic/{w['traffic']}.json"
    traffic = load_json(root / traffic_file)
    for key, data, file in [("family", config, conf["file"])] + [
            (key, traffic, traffic_file) for key in getattr(driver(traffic["kind"]), "NEEDS", ())]:
        if key not in data:
            raise SystemExit(f"kwsbench: {file} names no {key!r}, which {name} needs")
    recipe = traffic.get("recipe")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=load_json(root / "kwsbench" / "limits" / f"{name}.json"), end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"] if _reports(m, name, reported)],
        family=reference_module("family", config["family"], config["family"], FAMILY),
        recipe=None if recipe is None else reference_module("recipe", recipe, f"recipe_{recipe}", RECIPE))


def reference_module(key: str, value, stem: str, api: tuple[str, ...]) -> ModuleType:
    """``kwsbench/reference/<stem>.py``, which a data file's ``key`` names by ``value``; refuses a value that
    names no such module, and a module that lacks a name of ``api``."""
    named = isinstance(value, str) and re.fullmatch(r"[a-z][a-z0-9_]*", value)
    if not (named and (REFERENCE / f"{stem}.py").is_file()):
        raise SystemExit(f"kwsbench: the {key} {value!r} names no module kwsbench/reference/{stem}.py")
    module = importlib.import_module(f"kwsbench.reference.{stem}")
    missing = [a for a in api if not hasattr(module, a)]
    if missing:
        raise SystemExit(f"kwsbench: kwsbench/reference/{stem}.py, the {key} {value!r}, lacks {missing}")
    return module


def port(name: str):
    """The port's object named ``module:attribute``: the reference names the port's objects and imports none."""
    module, attribute = name.split(":")
    return getattr(importlib.import_module(module), attribute)


def load_file_module(path: Path, name: str) -> ModuleType:
    """The module in ``path``, loaded under ``name`` (file names may hold dots)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def driver(kind: str, root: Path = ROOT) -> ModuleType:
    path = root / "kwsbench" / "drivers" / f"{kind}.py"
    if not path.is_file():
        raise SystemExit(f"kwsbench: the traffic kind {kind!r} has no driver kwsbench/drivers/{kind}.py")
    return load_file_module(path, f"kwsbench_driver_{kind}")


def reader_path(metric: str, root: Path = ROOT) -> Path:
    """``metrics/<metric>.py``, or else ``metrics/<the part before the first dot>.py``."""
    own = root / "kwsbench" / "metrics" / f"{metric}.py"
    return own if own.is_file() else own.with_name(f"{metric.split('.', 1)[0]}.py")


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    path = reader_path(metric, root)
    return load_file_module(path, f"kwsbench_metric_{path.stem}")


def banned_loaded() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is banned, compared whole."""
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in BANNED_MODULES)


def fail(message: str, code: int = 2) -> None:
    print(f"kwsbench: {message}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def check_cards(chips: int) -> None:
    """Exit without a result unless CUDA is there with ``chips`` cards."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this benchmark runs on NVIDIA cards only")
    if torch.cuda.device_count() < chips:
        fail(f"the cell asks for {chips} cards; {torch.cuda.device_count()} are visible")


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the port's nvcc libraries already are:
    ``honk_tpu_torch/_build/``)."""
    cache = ROOT / ".kwsbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def emit(result: dict, checks: list[tuple[str, float, float]]) -> None:
    """Print each compared number beside its limit as the last lines on stderr, then the result line (the
    comparisons under ``check``, its last key) as the last line on stdout. Exits 3 without a result if a banned
    module is loaded."""
    found = banned_loaded()
    if found:
        fail(f"modules of JAX or the JAX package are loaded: {found}", 3)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    result["check"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    print(json.dumps(result), flush=True)
