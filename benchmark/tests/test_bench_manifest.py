"""BENCHMARK.json against the benchmark's contract, and the harness's lookup
of every cell's files by name."""

import json
import os
import re
import shutil

import pytest

from benchmark.harness import cell as cells

ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    return cells.manifest()


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)


def test_command_and_paths(manifest):
    assert 1 <= len(manifest["command"]) <= 32
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in manifest["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in manifest["paths"])


def test_names_and_units(manifest):
    groups = [manifest["configs"], manifest["workloads"], manifest["end_to_end"] + manifest["per_layer"]]
    for group in groups:
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        for n in names:
            assert NAME.match(n), n
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entry_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for entry in manifest["configs"] + manifest["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"] and "\t" not in entry["why"]


def test_every_cell_reports_enough(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in manifest["workloads"]:
        mine = [m["name"] for m in cells.metrics_of(w["name"], "end_to_end")]
        assert "setup_s" in mine and len(mine) >= 2
        layer = cells.metrics_of(w["name"], "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])


def test_per_layer_metrics_have_readers(manifest):
    for m in manifest["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_files_and_sources(manifest):
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert c["source"].startswith("https://")
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["reduced"] == c["reduced"] == []


@pytest.mark.parametrize("name", [w["name"] for w in cells.manifest()["workloads"]])
def test_every_cell_found_by_name(name):
    entry, config, traffic, workload = cells.find(name)
    assert entry["name"] == name
    assert traffic["driver"] in ("serve_stream", "train_step")
    assert os.path.exists(os.path.join(ROOT, "benchmark", "drivers", traffic["driver"] + ".py"))
    assert workload["limits"]
    assert (workload["config"], workload["traffic"]) == (entry["config"], entry["traffic"])


def test_unknown_cell_refused():
    with pytest.raises(KeyError):
        cells.find("no.such.cell")


def test_a_new_cell_is_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a cell through a manifest entry and new
    files, with no edit to any file the benchmark has."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = cells.manifest()
    before = {p: (tmp_path / "benchmark" / p).read_bytes()
              for p in ("run.py", "harness/cell.py", "drivers/serve_stream.py")}
    mix = dict(cells.load_json(os.path.join(ROOT, "benchmark", "traffic", "s4_cached.json")), streams=2)
    (tmp_path / "benchmark" / "traffic" / "s2_cached.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark" / "workloads" / "serve.basicvsr_mobile.s2_cached.json").write_text(
        json.dumps({"config": "basicvsr_mobile_x4", "traffic": "s2_cached", "limits": {"max_abs_err": 1.0}}))
    manifest["workloads"].append({"name": "serve.basicvsr_mobile.s2_cached", "config": "basicvsr_mobile_x4",
                                  "traffic": "s2_cached", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    entry, config, traffic, workload = cells.find("serve.basicvsr_mobile.s2_cached", root=str(tmp_path))
    assert traffic["streams"] == 2 and config["model_type"] == "basic"
    assert cells.metrics_of("serve.basicvsr_mobile.s2_cached", "end_to_end", root=str(tmp_path)) == [
        m for m in manifest["end_to_end"] if "workloads" not in m]
    for p, data in before.items():
        assert (tmp_path / "benchmark" / p).read_bytes() == data


def test_files_named_from_name_characters():
    for d, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        if "__pycache__" in d:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), ROOT)
            assert PATH.match(rel), rel
