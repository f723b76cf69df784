"""BENCHMARK.json against the benchmark's contract, and every name it uses
against a file of the benchmark."""

import json
import os
import re

import pytest

from conftest import REPO

BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(REPO, c["file"])) and c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def reports(cell):
    return {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        got = reports(w["name"])
        assert "setup_s" in got and len(got) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in reports(cell), (m["name"], cell)
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_roofline_has_an_mfu_beside_it():
    for m in BENCH["per_layer"]:
        if "_roofline" in m["name"]:
            assert any("mfu" in o["name"] and o["moves"] == m["moves"] and set(m["workloads"]) <= set(o["workloads"])
                       for o in BENCH["per_layer"])


def test_every_piece_has_its_file():
    bench = os.path.join(REPO, "benchmark")
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(bench, "metrics", f"{m['name']}.py")), m["name"]
    for w in BENCH["workloads"]:
        mix = json.load(open(os.path.join(bench, "traffic", f"{w['traffic']}.json")))
        assert os.path.exists(os.path.join(bench, "drivers", f"{mix['kind']}.py"))
        assert os.path.exists(os.path.join(bench, "limits", f"{w['config']}.json"))
        cell_file = os.path.join(bench, "cells", f"{w['name']}.json")
        if os.path.exists(cell_file):
            mix.update(json.load(open(cell_file)))
        if mix["kind"] == "grpc_open_loop":
            assert isinstance(mix["rate_per_s"], (int, float)) and mix["rate_per_s"] > 0


def test_a_full_check_fits_the_day():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_limits_lie_between_their_readings():
    for w in BENCH["workloads"]:
        lim = json.load(open(os.path.join(REPO, "benchmark", "limits", f"{w['config']}.json")))
        for name, limit in lim["limits"].items():
            r = lim["readings"][name]
            if r.get("control_min") is not None and r["control_min"] > 0:
                assert r["program_max"] <= limit < r["control_min"], name
            else:
                assert r["program_max"] <= limit, name
