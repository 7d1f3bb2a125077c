"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name; a cell, configuration and metric added as new files
and entries only."""

import json
import re
import shutil

import pytest

from halobench import harness
from halobench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "halobench/run.py"]
    assert BENCH["paths"] == ["halobench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries(kind):
    keys = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
    }[kind]
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert set(e) - {"workloads"} == keys, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        plan = harness.cell_plan(BENCH, w["name"], ROOT)
        names = {m["name"] for m in plan["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert plan["per_layer"]
        for m in plan["per_layer"]:
            assert m["moves"] in names


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load_by_name(cell):
    plan = harness.cell_plan(BENCH, cell, ROOT)
    cfg = plan["config"]
    assert cfg["name"] == plan["cell"]["config"]
    assert set(cfg["limits"]) == set(cfg["reference"]["numbers"])
    entry = {c["name"]: c for c in BENCH["configs"]}[cfg["name"]]
    for key in entry["reduced"]:
        assert key in cfg
    assert plan["traffic"]["name"] == plan["cell"]["traffic"]
    # the property list is frozen beside the configuration
    assert (ROOT / "halobench/configs" / cfg["keys"]).read_text().split()
    if cfg["parameter_file"]:
        assert json.loads((ROOT / "halobench/configs" / cfg["parameter_file"]).read_text())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_loads_and_reads_nothing_from_an_empty_run(metric):
    read = harness.load_metric(metric, ROOT)
    empty = dict(halos=0, window_s=0.0, setup_s=None, peak_bytes=0, passes=[], device=None,
                 work=None)
    assert read(empty) is None


def test_a_later_cell_is_new_files_and_entries(tmp_path):
    """A copy of the benchmark with a cell, a configuration, a traffic
    mix and a metric added as files and entries: the harness finds them
    with no file of it edited."""
    shutil.copytree(ROOT / "halobench", tmp_path / "halobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "halobench/configs/dmo_default.json").read_text())
    cfg["name"] = "dmo_other"
    (tmp_path / "halobench/configs/dmo_other.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "halobench/traffic/hmf.box60.chunk1.json").read_text())
    traffic.update(name="hmf.box40.chunk2", boxsize=40.0, nr_chunks=2)
    (tmp_path / "halobench/traffic/hmf.box40.chunk2.json").write_text(json.dumps(traffic))
    (tmp_path / "halobench/metrics/passes.py").write_text(
        "def read(run):\n    return len(run['passes']) or None\n")
    bench["configs"].append(dict(bench["configs"][0], name="dmo_other",
                                 file="halobench/configs/dmo_other.json"))
    bench["workloads"].append(dict(name="other.chunk2", config="dmo_other",
                                   traffic="hmf.box40.chunk2", chips=1, why="a test"))
    bench["per_layer"].append(dict(name="passes", unit="passes", better="higher",
                                   source="program_counter", layer="entry",
                                   moves="halos_per_s", workloads=["other.chunk2"]))
    plan = harness.cell_plan(bench, "other.chunk2", tmp_path)
    assert plan["config"]["name"] == "dmo_other"
    assert plan["traffic"]["boxsize"] == 40.0 and plan["traffic"]["nr_chunks"] == 2
    # every metric without a list of cells, and the new one that lists it
    assert [m["name"] for m in plan["per_layer"]] == [
        m["name"] for m in bench["per_layer"] if "workloads" not in m or "other.chunk2" in m["workloads"]]
    assert "passes" in [m["name"] for m in plan["per_layer"]]
    assert harness.load_metric("passes", tmp_path)({"passes": [1, 2]}) == 2
