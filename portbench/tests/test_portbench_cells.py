"""BENCHMARK.json and the files it names: every cell parses, and every
configuration, traffic mix, limit file and per-layer reader is found."""

import json
import re

import pytest

from portbench import harness
from portbench.metrics import reader

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_parse(workload):
    bench, cell, cfg, traffic, limits = harness.load_cell(workload)
    assert cell["chips"] == 1
    assert cfg["name"] == cell["config"]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    for key in entry["reduced"]:
        assert cfg[key] != cfg["published"][key], key
    assert traffic["entry"] in ("assemble", "full", "contigs")
    assert all(isinstance(v, (int, float)) for v in limits.values())
    reported = harness.cell_metrics(bench, workload, False)
    assert {m["name"] for m in reported} >= {"setup_s", "genome_kb_per_s"}
    assert harness.cell_metrics(bench, workload, True)


@pytest.mark.parametrize("name", PER_LAYER)
def test_every_per_layer_metric_has_a_reader(name):
    assert callable(reader(name))
