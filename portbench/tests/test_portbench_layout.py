"""BENCHMARK.json keeps to the contract's names and units, and every file
a cell needs is found by name."""
import json
import re

import pytest

from pbcore import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(wl):
    w = spec.workload(BENCH, wl)
    cfg = spec.config(BENCH, w["config"])
    assert cfg["name"] == w["config"]
    traffic = spec.traffic(w["traffic"])
    gen = spec.generator(traffic["generator"])
    assert callable(gen.make)
    lim = spec.limits(wl)
    assert lim["limits"]
    e2e = spec.cell_metrics(BENCH, wl, "end_to_end")
    assert {"setup_s", "pairs_per_s"} <= {m["name"] for m in e2e}
    assert spec.cell_metrics(BENCH, wl, "per_layer")


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_files(m):
    mod = spec.metric(m["name"])
    assert (mod.NAME, mod.UNIT, mod.SOURCE) == (m["name"], m["unit"], m["source"])
    assert callable(mod.read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


def test_configs_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("portbench/configs/")
