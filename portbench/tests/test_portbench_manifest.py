"""BENCHMARK.json against the benchmark's contract, and the harness finding
each cell's configuration, traffic mix, limits and metric readers by name."""

import json
import re

import pytest

import portbench_tiny as tiny
from pbench import harness

MAN = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((tiny.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_unique_names():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_harness_finds_cell_files(cell):
    work, config, traffic, limits = harness.cell_files(cell)
    assert work["chips"] == 1
    assert config["name"] == work["config"]
    assert traffic["request"] in ("ros1_sweep", "ros2_sweep", "gare_newton")
    assert limits and all("limit" in v for v in limits.values())


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    mod = harness.load_reader(metric["name"])
    assert callable(mod.read)


def test_a_suffixed_metric_falls_back_to_its_base_reader():
    base = harness.load_reader("k1_roofline_pct")
    for name in ("k1_roofline_pct.step", "k1_roofline_pct.newton", "k1_roofline_pct.a.b"):
        mod = harness.load_reader(name)
        assert mod.__file__ == base.__file__
    with pytest.raises(FileNotFoundError):
        harness.load_reader("no_such_metric.step")


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in harness.metric_names(w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metric_names(w["name"], True)


def test_per_layer_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_configs_sources_and_files():
    for c in MAN["configs"]:
        conf = json.loads((tiny.ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/")
        assert conf["n"] == 79841 and c["reduced"] == []
