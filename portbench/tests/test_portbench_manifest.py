"""``BENCHMARK.json`` and every file it names parse and hold what the harness
reads; a cell, a configuration, a traffic mix or a per-layer metric is added
by new files and entries alone."""

import json
import re

import pytest

from portbench import harness
from portbench.tests import helpers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200 and len(c["source"]) <= 200
        assert c["file"].startswith("portbench/")
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in MANIFEST["end_to_end"]} == {"train_samples_per_s", "setup_s"}
    for m in MANIFEST["end_to_end"]:
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["moves"] == "train_samples_per_s"
        assert set(m.get("workloads", [])) <= {w["name"] for w in MANIFEST["workloads"]}


@pytest.mark.parametrize("workload", helpers.cells())
def test_every_cell_loads_its_files(workload):
    cell = harness.load_cell(harness.ROOT, workload)
    cfg = cell.config
    assert set(cfg["limits"]) == set(harness.kind_of(cell).NUMBERS)
    assert cfg["precision"] == "float32" and cfg["control"] in ("bfloat16", "tfloat32")
    for key in ("rows", "minibatch", "steps_per_call", "terminal_share",
                "impossible_action_share", "profiled_calls"):
        assert key in cell.traffic
    assert (harness.HERE / "kinds" / f"{cfg['kind']}.py").is_file()
    assert (harness.HERE / "adapters" / f"{cfg['adapter']}.py").is_file()
    assert (harness.HERE / "reference" / f"{cfg['reference']}.py").is_file()
    assert [m["name"] for m in cell.end_to_end] == ["train_samples_per_s", "setup_s"]
    for m in cell.per_layer:
        assert callable(harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py").read)
    for m in cell.end_to_end:
        assert callable(harness.load_module(harness.HERE / "end_to_end" / f"{m['name']}.py").read)


def test_a_traffic_file_and_an_entry_make_a_new_cell(tmp_path):
    root = helpers.copy_benchmark(tmp_path)
    traffic = json.loads((root / "portbench/traffic/table10m_b16384.json").read_text())
    traffic.update(name="table_small", rows=3000, minibatch=2048, steps_per_call=2)
    (root / "portbench/traffic/table_small.json").write_text(json.dumps(traffic))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "dqn_full.table_small", "config": "dqn_full",
                                  "traffic": "table_small", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.load_cell(root, "dqn_full.table_small")
    assert cell.traffic["minibatch"] == 2048
    result = harness.measure(cell, 2**31 + 77, 0.2, False, device="cpu")
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_a_configuration_file_and_an_entry_make_a_new_cell(tmp_path):
    root = helpers.copy_benchmark(tmp_path)
    cfg = json.loads((root / "portbench/configs/dqn_full.json").read_text())
    cfg.update(name="dqn_relu", activation="relu")
    (root / "portbench/configs/dqn_relu.json").write_text(json.dumps(cfg))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "dqn_relu", "source": "a test", "reduced": [],
                                "file": "portbench/configs/dqn_relu.json", "why": "a test"})
    manifest["workloads"].append({"name": "dqn_relu.table10m_b16384", "config": "dqn_relu",
                                  "traffic": "table10m_b16384", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = helpers.small(harness.load_cell(root, "dqn_relu.table10m_b16384"))
    result = harness.measure(cell, 5, 0.2, False, device="cpu")
    assert result["correct"], result["check"]


def test_a_metric_file_and_an_entry_are_read_by_name(tmp_path):
    """A per-layer and an end-to-end metric, each a new reader file and a new
    entry, come out of a run of the copied checkout, read there."""
    root = helpers.copy_benchmark(tmp_path)
    (root / "portbench/metrics/steps_per_s_unprofiled.py").write_text(
        "def read(ctx):\n    return ctx.per_s['steps']\n")
    (root / "portbench/end_to_end/calls_per_s.py").write_text(
        "def read(window):\n    return len(window.calls_s) / window.seconds\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({"name": "steps_per_s_unprofiled", "unit": "steps/s",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "whole step", "moves": "train_samples_per_s"})
    manifest["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                                   "bound": 0.25, "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    workload = helpers.cells()[0]
    cell = helpers.small(harness.load_cell(root, workload))
    assert cell.root == root and [m["name"] for m in cell.per_layer][-1] == "steps_per_s_unprofiled"
    traced = harness.measure(cell, 9, 0.2, True, device="cpu")
    assert traced["correct"], traced["check"]
    assert traced["metrics"]["steps_per_s_unprofiled"]["value"] > 0
    plain = harness.measure(cell, 9, 0.2, False, device="cpu")
    assert set(plain["metrics"]) == {"train_samples_per_s", "setup_s", "calls_per_s"}
    assert plain["metrics"]["calls_per_s"]["unit"] == "calls/s"
