"""BENCHMARK.json against the benchmark's contract, and the rule that a
cell, a configuration or a per-layer metric is added as files alone."""

import json
import os
import re
import shutil

import pytest

from pdbench import spec

ROOT = spec.ROOT
BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = lambda s: isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
METRIC_KEYS = {"end_to_end": {"name", "unit", "better", "bound", "source"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert all(TEXT(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and os.path.isdir(os.path.join(ROOT, p))
        assert not p.startswith("/") and ".." not in p.split("/")


def test_command_names_only_files_under_paths():
    for word in BENCH["command"][1:]:
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and TEXT(c["source"]) and TEXT(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]


def test_workloads():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert 1 <= len(pairs) <= 24 and len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(pairs) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT(w["why"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH[kind]:
        assert set(m) - {"workloads"} == METRIC_KEYS[kind]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert m["moves"] in e2e and TEXT(m["layer"])
            if m["name"].split(".")[0].endswith("_roofline"):
                assert m["unit"] == "%"
    if kind == "end_to_end":
        assert "setup_s" in e2e


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        cell = spec.cell(BENCH, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        # a per-layer metric moves an end-to-end metric that its cell reports
        assert {m["moves"] for m in cell.per_layer} <= names


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(name):
    cell = spec.cell(BENCH, name)
    assert cell.config["family"] in ("sd15", "sd3")
    assert {"policy", "batch", "size", "steps", "guidance"} <= set(cell.traffic)
    assert set(cell.limits["limits"]) and all(v > 0 for v in cell.limits["limits"].values())
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_a_new_cell_and_metric_are_files_only(tmp_path):
    """A cell, its traffic, its limits and a per-layer metric added as new
    files and entries resolve with no edit of a file that exists."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "pdbench"), root / "pdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    traffic = dict(spec.cell(BENCH, "sd15.int8.b8").traffic, batch=4)
    (root / "pdbench" / "traffic" / "sd15.int8.b4.json").write_text(json.dumps(traffic))
    (root / "pdbench" / "limits" / "sd15.int8.b4.json").write_text(
        (root / "pdbench" / "limits" / "sd15.int8.b8.json").read_text())
    (root / "pdbench" / "metrics" / "extra_ms.py").write_text(
        "def read(rec):\n    return 1.5\n")
    bench["workloads"].append({"name": "sd15.int8.b4", "config": "sd15_prompt_diffusion",
                               "traffic": "sd15.int8.b4", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "extra_ms", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "models: the denoiser",
                               "moves": "images_per_s.sd15", "workloads": ["sd15.int8.b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell(spec.benchmark(str(root)), "sd15.int8.b4", str(root))
    assert cell.traffic["batch"] == 4
    assert [m["name"] for m in cell.per_layer][-1] == "extra_ms"
    assert spec.reader("extra_ms", str(root))({}) == 1.5
