"""BENCHMARK.json against the benchmark's contract, and discovery by name."""

import json
import re

import pytest

from portbench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = common.manifest()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or ".roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_the_contract_asks():
    for w in BENCH["workloads"]:
        cell = common.cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_discovery_by_name():
    """Each cell's files are found by the names the manifest gives."""
    for w in BENCH["workloads"]:
        cell = common.cell(w["name"])
        conf = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
        assert cell.config["name"] == w["config"] == conf["name"]
        assert conf["file"].startswith("portbench/configs/")
        driver = common.driver(cell)
        assert driver.__name__ == f"portbench.traffic.{cell.traffic['kind']}"
        assert callable(driver.run) and callable(driver.control)
        assert set(cell.limits)
        for m in cell.per_layer:
            assert callable(common.metric_reader(m["name"]))
            assert common.metric_reader(m["name"])({}) is None  # nothing to read: nothing


def test_configs_name_their_cuts():
    for c in BENCH["configs"]:
        cfg = common.load_json(common.ROOT / c["file"])
        assert c["reduced"] == cfg["reduced"]
        assert cfg["source"] and "assumed" in cfg
        assert len(c["source"]) <= 200


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        common.cell("no-such-cell")


def test_a_traffic_kind_must_be_a_module_name():
    cell = common.cell(BENCH["workloads"][0]["name"])
    cell.traffic = dict(cell.traffic, kind="../fit")
    with pytest.raises(SystemExit):
        common.driver(cell)
