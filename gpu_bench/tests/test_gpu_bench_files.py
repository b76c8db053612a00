"""Every file of the benchmark parses and BENCHMARK.json keeps to the
benchmark's contract."""
import ast
import json
import re

import pytest

from gpu_bench import harness

from small import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert b["paths"] == ["gpu_bench"] and 1 <= b["run_seconds"] <= 51
    assert all(TEXT.match(w) for w in b["command"])
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and c["file"].startswith("gpu_bench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        assert w["config"] in {c["name"] for c in b["configs"]}
    assert len(cells) == len(b["workloads"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in b["per_layer"]:
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", [c])
    for c in cells:         # every cell: setup_s, another e2e, a per-layer
        assert len(harness.cell_metrics(b, c, False)) >= 2
        assert harness.cell_metrics(b, c, True)


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_data_files_parse(kind):
    files = sorted((ROOT / "gpu_bench" / kind).glob("*.json"))
    assert files
    for f in files:
        assert isinstance(json.loads(f.read_text()), dict), f


def test_every_cell_and_metric_has_its_files():
    b = bench()
    for w in b["workloads"]:
        wl = json.loads((ROOT / "gpu_bench" / "workloads"
                         / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert (ROOT / "gpu_bench" / "drivers"
                / f"{wl['driver']}.py").exists()
        assert wl["limits"]
    for m in b["end_to_end"] + b["per_layer"]:
        mod = harness.reader(m["name"])
        assert callable(mod.read), m["name"]


def test_metric_files_parse():
    files = sorted((ROOT / "gpu_bench" / "metrics").glob("*.py"))
    assert len(files) > 10
    for f in files:
        ast.parse(f.read_text(), str(f))
