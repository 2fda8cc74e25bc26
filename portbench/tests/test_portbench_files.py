"""The harness finds every configuration, workload, driver and metric by
name, and BENCHMARK.json keeps to the benchmark's contract."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert not any(word.startswith("/") or ".." in word for word in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    entry, workload, config = run.cell_files(cell, BENCH)
    assert workload["config"] == entry["config"] == config["name"]
    assert workload["traffic"] == entry["traffic"]
    assert workload["why"] == entry["why"]
    assert (ROOT / "portbench" / "drivers" / f"{workload['driver']}.py").exists()
    assert entry["chips"] in (1, 4)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(config):
    path = ROOT / config["file"]
    assert path.parts[len(ROOT.parts)] == "portbench"
    data = json.loads(path.read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    assert not any(k.endswith(("_dim", "_rank", "_dims", "heads")) for k in config["reduced"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_readers_are_found_by_name(metric):
    assert callable(run.reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for cell in metric["workloads"]:
        e2e, per_layer = run.cell_metrics(BENCH, cell)
        assert metric["moves"] in {m["name"] for m in e2e}, f"{cell} does not report {metric['moves']}"
        assert metric in per_layer


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_names_units_and_keys(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= allowed | {"bound"} and 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert set(metric) <= allowed | {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e, per_layer = run.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    for key in ("name", "config", "traffic"):
        assert NAME.match(entry[key])
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(spelled) == 1 for spelled in layers.values())


def test_a_new_cell_config_and_metric_are_found_from_new_files_alone(tmp_path, monkeypatch):
    """A later change adds a configuration, a workload and a metric reader
    as new files and entries: the harness finds each by its name."""
    here = tmp_path / "portbench"
    for sub in ("configs", "workloads", "metrics"):
        (here / sub).mkdir(parents=True)
    (here / "configs" / "new-model.json").write_text(json.dumps({"name": "new-model", "source": "x"}))
    (here / "workloads" / "new-model.cell.json").write_text(json.dumps(
        {"config": "new-model", "traffic": "t", "driver": "serve_closed", "why": "w"}))
    (here / "metrics" / "new_metric.serve.py").write_text("def read(record):\n    return record.get('x')\n")
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "new-model.cell", "config": "new-model", "traffic": "t", "chips": 1, "why": "w"}])
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "new_metric.serve", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "l", "moves": "latency_p95_ms", "workloads": ["new-model.cell"]}]
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + ["new-model.cell"])
                           if m["name"] == "latency_p95_ms" else m for m in BENCH["end_to_end"]]
    monkeypatch.setattr(run, "HERE", here)
    entry, workload, config = run.cell_files("new-model.cell", bench)
    assert config["name"] == "new-model" and workload["driver"] == "serve_closed"
    _, per_layer = run.cell_metrics(bench, "new-model.cell")
    assert [m["name"] for m in per_layer] == ["new_metric.serve"]
    assert run.reader("new_metric.serve")({"x": 3.0}) == 3.0
