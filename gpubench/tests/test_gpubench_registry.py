"""The harness finds every part of a cell by its name, and takes a new
configuration, traffic mix, cell and per-layer metric from new files
alone; BENCHMARK.json keeps to the benchmark's contract."""

import json
import re
import shutil
from pathlib import Path

import pytest

from gpubench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_each_cell_resolves_to_its_files():
    reg = harness.Registry()
    for w in reg.bench["workloads"]:
        cell = reg.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert reg.driver(cell.config["engine"]).unit in ("epoch", "round")
        assert cell.limits
    for m in reg.bench["end_to_end"] + reg.bench["per_layer"]:
        assert callable(reg.metric_reader(m["name"]))


def test_a_missing_file_is_named(tiny):
    (tiny.files / "traffic" / "sync-fresh-sgd.json").unlink()
    with pytest.raises(FileNotFoundError, match="sync-fresh-sgd"):
        tiny.cell("sync3-b100-sgd")


def test_new_config_traffic_cell_and_metric_come_from_new_files_alone(tiny, tmp_path):
    files, bench_path = tiny.files, tmp_path / "BENCHMARK.json"
    cfg = json.loads((files / "configs" / "rcv1-svm-sync3.json").read_text())
    cfg.update(name="rcv1-svm-sync2", engine_args={**cfg["engine_args"], "virtual_workers": 2})
    (files / "configs" / "rcv1-svm-sync2.json").write_text(json.dumps(cfg))
    (files / "traffic" / "sync-epoch-sgd.json").write_text(
        json.dumps({"why": "permutations", "engine_args": {"sampling": "epoch"}}))
    limits = json.loads((files / "workloads" / "sync3-b100-sgd.json").read_text())["limits"]
    (files / "workloads" / "sync2-epoch.json").write_text(json.dumps({"limits": limits}))
    (files / "metrics" / "sync.epochs_in_window.py").write_text(
        "def read(run):\n    return float(run.whole.units)\n")
    bench = json.loads(bench_path.read_text())
    bench["workloads"].append({"name": "sync2-epoch", "config": "rcv1-svm-sync2",
                               "traffic": "sync-epoch-sgd", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        m.setdefault("workloads", [w["name"] for w in bench["workloads"]])
    bench["per_layer"] = [{"name": "sync.epochs_in_window", "unit": "epochs", "better": "higher",
                           "source": "host_clock", "layer": "trainer", "moves": "samples_per_s",
                           "workloads": ["sync2-epoch"]}]
    bench_path.write_text(json.dumps(bench))
    reg = harness.Registry(bench_path, files)
    cell = reg.cell("sync2-epoch")
    assert cell.settings["virtual_workers"] == 2 and cell.settings["sampling"] == "epoch"
    t = __import__("time").perf_counter()
    out = harness.run_cell(reg, "sync2-epoch", 11, 0.2, False, t, device="cpu", log=lambda m: None)
    assert out["correct"] and set(out["metrics"]) == {"samples_per_s", "setup_s"}
    part = harness.Part(1.0, 7, 1, [0.0, 1.0])
    assert reg.metric_reader("sync.epochs_in_window")(harness.Run(cell, part, part)) == 7.0


def test_benchmark_json_keeps_to_the_contract():
    bench = json.loads(harness.BENCHMARK.read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpubench"] and bench["command"][1].startswith("gpubench/")
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    root = harness.BENCHMARK.parent
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["name"] in used
        assert c["file"].startswith("gpubench/") and (root / c["file"]).is_file()
        assert json.loads((root / c["file"]).read_text())["name"] == c["name"]
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["source"] in SOURCES and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells and "\n" not in m["layer"]
    for cell in cells:  # every cell reports setup_s, another end-to-end metric, a per-layer one
        assert len(harness.Registry().metrics("end_to_end", cell)) >= 2
        assert harness.Registry().metrics("per_layer", cell)


def test_the_tiny_tree_is_a_copy(tmp_path):
    from conftest import tiny_tree

    root = tiny_tree(tmp_path)
    assert (root / "gpubench" / "drivers" / "sync_trainer.py").is_file()
    shutil.rmtree(root / "gpubench")
