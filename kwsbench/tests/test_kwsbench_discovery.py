"""A cell, a configuration, a model family, a traffic mix, a recipe and a per-layer metric are found by name:
added as files alone."""

import json
import shutil

import pytest
import torch
from conftest import ROOT, cells, rehearsal

from kwsbench import common, faults, harness

KINDS = {p.stem for p in (ROOT / "kwsbench" / "drivers").glob("*.py")} - {"__init__"}


def _copy_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits", "metrics", "rehearse"):
        shutil.copytree(ROOT / "kwsbench" / sub, tmp_path / "kwsbench" / sub)
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_every_cell_of_the_benchmark_is_found_with_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.chips == w["chips"] and cell.traffic["kind"] in KINDS
        assert cell.family.__name__ == f"kwsbench.reference.{cell.config['family']}"
        needs = getattr(harness.driver(cell.traffic["kind"]), "NEEDS", ())
        assert (cell.recipe is not None) == ("recipe" in needs)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer, f"{w['name']} reports no per-layer metric"
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]).read)
        shrink = rehearsal(w["name"])
        assert {"config", "traffic", "faults"} <= set(shrink) and set(shrink["faults"]) <= set(faults.NAMES)


def test_a_new_cell_configuration_traffic_and_metric_are_found_from_files_alone(tmp_path):
    bench = _copy_benchmark(tmp_path)
    conf = json.loads((ROOT / "kwsbench/configs/res8.json").read_text())
    (tmp_path / "kwsbench/configs/res8-wide.json").write_text(json.dumps(dict(conf, name="res8-wide")))
    (tmp_path / "kwsbench/traffic/score.b512.json").write_text(
        json.dumps(dict(json.loads((ROOT / "kwsbench/traffic/score.b256.json").read_text()), batch=512)))
    (tmp_path / "kwsbench/limits/res8-wide.score.b512.json").write_text('{"logit_gap": 1, "row_gap": 1}')
    (tmp_path / "kwsbench/rehearse/res8-wide.score.b512.json").write_text(
        (ROOT / "kwsbench/rehearse/res8.score.b256.json").read_text())
    (tmp_path / "kwsbench/metrics/batches_traced.py").write_text(
        "def read(r):\n    return r.counters.get('traced_units')\n")
    bench["configs"].append({"name": "res8-wide", "source": "https://arxiv.org/abs/1710.10361",
                             "file": "kwsbench/configs/res8-wide.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "res8-wide.score.b512", "config": "res8-wide", "traffic": "score.b512",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("res8-wide.score.b512")
    bench["per_layer"].append({"name": "batches_traced", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "a test", "moves": "score_audio_s_per_s",
                               "workloads": ["res8-wide.score.b512"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell("res8-wide.score.b512", root=tmp_path)
    assert cell.traffic["batch"] == 512 and cell.config["name"] == "res8-wide"
    assert [m["name"] for m in cell.end_to_end] == ["score_audio_s_per_s", "setup_s"]
    assert "batches_traced" in [m["name"] for m in cell.per_layer]
    module = harness.reader("batches_traced", root=tmp_path)
    reading = common.Reading(None, {"traced_units": 7}, cell.config, cell.traffic, "cpu", 1)
    assert module.read(reading) == 7
    # The tests rehearse it, hold it to its faults and look for JAX in it, from its rehearsal file.
    assert "res8-wide.score.b512" in cells(tmp_path) and rehearsal("res8-wide.score.b512", tmp_path)["faults"]
    # The cells already there do not take the new metric.
    assert "batches_traced" not in [m["name"] for m in harness.find_cell("res8.score.b256", tmp_path).per_layer]


def test_a_metric_without_a_reader_of_its_own_reads_the_one_named_before_its_first_dot(tmp_path):
    _copy_benchmark(tmp_path)
    assert harness.reader_path("mfu.train", tmp_path).name == "mfu.py"
    assert harness.reader_path("train_step.launches", tmp_path).name == "train_step.launches.py"
    (tmp_path / "kwsbench/metrics/mfu.train.py").write_text("def read(r):\n    return 1.0\n")
    assert harness.reader_path("mfu.train", tmp_path).name == "mfu.train.py"


def test_a_per_layer_metric_without_workloads_goes_to_every_cell_reporting_what_it_moves(tmp_path):
    bench = _copy_benchmark(tmp_path)
    bench["per_layer"].append({"name": "mfu.any", "unit": "%", "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "train_audio_s_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    has = {w["name"]: "mfu.any" in [m["name"] for m in harness.find_cell(w["name"], tmp_path).per_layer]
           for w in bench["workloads"]}
    assert has == {"res15.train.b64": True, "res8.score.b256": False, "res15.recordings.60s": False,
                   "res15.train.dp4": True}


def test_the_benchmark_file_keeps_its_format():
    """Names, units, keys and lengths as the benchmark's format allows, and every file it names in place."""
    import re

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    line = re.compile(r"^[^\t\n]{1,200}$")
    assert 1 <= bench["run_seconds"] <= 51 and bench["paths"] == ["kwsbench"]
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert line.match(c["source"]) and line.match(c["why"]) and c["file"].startswith("kwsbench/")
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
    cells = {w["name"] for w in bench["workloads"]}
    assert len(cells) == len(bench["workloads"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["config"] in configs
        assert name.match(w["name"]) and name.match(w["traffic"]) and line.match(w["why"]) and w["chips"] in (1, 4)
        assert (ROOT / "kwsbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "kwsbench/limits" / f"{w['name']}.json").is_file()
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(cells) // 4)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert name.match(m["name"]) and unit.match(m["unit"]) and line.match(m["layer"]) and m["moves"] in e2e
        assert harness.reader_path(m["name"]).is_file()
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        got = harness.find_cell(cell)
        assert len(got.end_to_end) >= 2 and got.per_layer
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _write(path, data):
    path.write_text(json.dumps(data))


@pytest.mark.parametrize("cell,file,key,value,named", [
    ("res8.score.b256", "configs/res8.json", "family", None, "'family'"),
    ("res15.train.b64", "traffic/train.b64.json", "recipe", None, "'recipe'"),
    ("res15.train.b64", "configs/res15.json", "family", "kwt", "reference/kwt.py"),
    ("res15.train.b64", "traffic/train.b64.json", "recipe", "adamw", "reference/recipe_adamw.py"),
], ids=["no-family", "no-recipe", "family-without-module", "recipe-without-module"])
def test_a_cell_whose_family_or_recipe_is_missing_or_has_no_module_is_refused_by_name(tmp_path, cell, file, key,
                                                                                      value, named):
    _copy_benchmark(tmp_path)
    path = tmp_path / "kwsbench" / file
    data = json.loads(path.read_text())
    if value is None:
        del data[key]
    else:
        data[key] = value
    _write(path, data)
    with pytest.raises(SystemExit, match=named):
        harness.find_cell(cell, root=tmp_path)


# cnn-trad-pool2 (castorini/honk's ConfigType.CNN_TRAD_POOL2) as the benchmark would run it, with no dropout so
# that the reference can follow its training steps.
CNN_TRAD_POOL2 = {
    "name": "cnn-trad-pool2", "source": "https://www.isca-archive.org/interspeech_2015/sainath15b_interspeech.html",
    "family": "cnn", "registry_name": "cnn-trad-pool2", "n_labels": 12, "dropout_prob": 0.0, "height": 101,
    "width": 40, "n_feature_maps1": 64, "conv1_size": [20, 8], "conv1_pool": [2, 2], "conv1_stride": [1, 1],
    "n_feature_maps2": 64, "conv2_size": [10, 4], "conv2_stride": [1, 1], "conv2_pool": [1, 1], "tf_variant": True,
    "compute_dtype": "bfloat16"}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Training in float32: under the Honk recipe's learning rate of 0.1 the narrow cnn's loss grows 2.5 -> 11 -> 51
# in three steps, so bf16's rounding moves the later losses by percents (the bf16 witness more than the program).
@pytest.mark.parametrize("traffic,like,dtype", [("score.b256", "res8.score.b256", "bfloat16"),
                                                ("train.b64", "res15.train.b64", "float32")],
                         ids=["score", "train"])
def test_a_configuration_of_another_family_is_added_as_files_alone_and_agrees_with_its_reference(
        tmp_path, one_thread, traffic, like, dtype):
    """cnn-trad-pool2's configuration, limits (the res cell's of the same traffic) and rehearsal (narrow) written
    as files; the driver's readings on the CPU: the program against the cnn reference within the res cell's
    limits."""
    bench = _copy_benchmark(tmp_path)
    name = f"cnn-trad-pool2.{traffic}"
    _write(tmp_path / "kwsbench/configs/cnn-trad-pool2.json", dict(CNN_TRAD_POOL2, compute_dtype=dtype))
    shutil.copy(ROOT / f"kwsbench/limits/{like}.json", tmp_path / f"kwsbench/limits/{name}.json")
    shrink = dict(rehearsal(like), config={"n_feature_maps1": 8, "n_feature_maps2": 8})
    _write(tmp_path / f"kwsbench/rehearse/{name}.json", shrink)
    bench["configs"].append({"name": "cnn-trad-pool2", "source": CNN_TRAD_POOL2["source"],
                             "file": "kwsbench/configs/cnn-trad-pool2.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": name, "config": "cnn-trad-pool2", "traffic": traffic, "chips": 1,
                               "why": "a test"})
    _write(tmp_path / "BENCHMARK.json", bench)

    cell = harness.find_cell(name, root=tmp_path)
    assert cell.family.__name__ == "kwsbench.reference.cnn"
    r = rehearsal(name, tmp_path)
    cell.config.update(r["config"])
    cell.traffic.update(r["traffic"])
    got = harness.driver(cell.traffic["kind"]).readings(cell, 2_000_000_051, torch.device("cpu"), ["program"])
    values = {n: v for n, v, _ in got["program"]}
    assert set(cell.limits) <= set(values)
    for n, limit in cell.limits.items():
        assert values[n] <= limit, (n, values[n], limit)
