"""Where the benchmark finds a cell's files, by the names in BENCHMARK.json.

A configuration is `configs/<config>.json`, a traffic mix
`traffic/<traffic>.json` (which names its generator,
`generators/<generator>.py`), a per-layer metric `metrics/<name>.py`, and
a cell's limits for `correct` are `limits/<workload>.json`.  A later cell,
configuration or metric is a file of its own and an entry in
BENCHMARK.json; nothing here changes for it."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

PB = Path(__file__).resolve().parents[1]          # portbench/
ROOT = PB.parent                                  # the checkout


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> Dict:
    return json.loads(Path(path).read_text())


def _by_name(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: Dict, name: str) -> Dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: Dict, name: str) -> Dict:
    """The configuration's file (under configs/), as a dict."""
    entry = _by_name(bench["configs"], name, "configuration")
    return json.loads((ROOT / entry["file"]).read_text())


def traffic(name: str) -> Dict:
    return json.loads((PB / "traffic" / f"{name}.json").read_text())


def limits(workload_name: str) -> Dict:
    return json.loads((PB / "limits" / f"{workload_name}.json").read_text())


def _load_file(path: Path, modname: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(name: str) -> ModuleType:
    """generators/<name>.py: make(params, seed) -> (img1, img2, H_true)."""
    return _load_file(PB / "generators" / f"{name}.py", f"pbgen_{name}")


def metric(name: str) -> ModuleType:
    """metrics/<name>.py: NAME, UNIT, SOURCE and read(record) -> number or
    None (nothing to read)."""
    return _load_file(PB / "metrics" / f"{name}.py",
                      "pbmetric_" + name.replace(".", "_").replace("-", "_"))


def cell_metrics(bench: Dict, workload_name: str, kind: str) -> List[Dict]:
    """The `end_to_end` or `per_layer` entries that the cell reports: those
    that list it under `workloads`, and those without that key."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload_name in m["workloads"]]
