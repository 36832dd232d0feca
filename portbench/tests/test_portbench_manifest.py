"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

from portbench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
        for e in BENCH[kind]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        cell, cfg, mix, gen = harness.load_cell(w["name"], BENCH)
        assert hasattr(gen, "Traffic")
        conf = [c for c in BENCH["configs"] if c["name"] == cell["config"]][0]
        assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
        assert cfg["reduced"] == conf["reduced"] == []
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_each_metric_file_is_a_reader():
    """A metric's file holds its reader; its unit, layer, source and moves
    are BENCHMARK.json's alone."""
    for m in BENCH["per_layer"]:
        mod = harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py")
        assert callable(mod.read), m["name"]
        assert not {"UNIT", "LAYER", "SOURCE", "MOVES"} & set(vars(mod)), m["name"]


def test_moves_reported_where_the_metric_is():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        reported = [m for m in BENCH["end_to_end"] if harness.reports(m, w["name"], BENCH)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        layer = [m for m in BENCH["per_layer"] if harness.reports(m, w["name"], BENCH)]
        assert layer, w["name"]
        for m in layer:
            assert harness.reports(e2e[m["moves"]], w["name"], BENCH), (m["name"], w["name"])


def test_a_full_check_fits_with_24_cells():
    run = BENCH["run_seconds"] + 60
    assert (2 + 14 * 24) * run + 24 * 2 * 90 + 1200 <= 43200


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(0 < len(x) <= 200 and "\n" not in x and "\t" not in x for x in layers)
