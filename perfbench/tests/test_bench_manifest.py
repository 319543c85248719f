"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import math
import re

import pytest

from perfbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return manifest.load_benchmark()


def test_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["perfbench"]
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] \
        + bench["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_one_line_texts(bench):
    texts = [c["why"] for c in bench["configs"]] \
        + [w["why"] for w in bench["workloads"]] \
        + [c["source"] for c in bench["configs"]] \
        + [m["layer"] for m in bench["per_layer"]] + bench["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_four_chip_share(bench):
    cells = bench["workloads"]
    four = [w for w in cells if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in cells)
    assert len(four) <= max(1, math.floor(0.25 * len(cells)))


def test_pairs_unique_and_configs_used(bench):
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_each_cell_reports_what_it_must(bench):
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer one; each per-layer metric's cells report what it moves."""
    for w in bench["workloads"]:
        cell = manifest.load_cell(w["name"], bench)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            e2e = {x["name"] for x in manifest.load_cell(cell, bench).end_to_end}
            assert m["moves"] in e2e


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        assert (manifest.ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        cell = manifest.load_cell(w["name"], bench)
        assert manifest.generator_class(cell.traffic["kind"]) is not None
        assert set(cell.traffic["limits"])
    for m in bench["per_layer"]:
        assert callable(manifest.layer_reader(m["name"]))


def test_command_stays_in_paths(bench):
    assert bench["command"][0] == "python3"
    for word in bench["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert word.startswith("perfbench/")
