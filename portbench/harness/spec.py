"""BENCHMARK.json and the benchmark's data files, found by name.

A cell names a configuration (its `file` in BENCHMARK.json) and a traffic
mix (portbench/traffic/<traffic>.json); every metric is a reader
portbench/metrics/<name>.py and every roofline's work counter
portbench/work/<kernel>.py; a configuration's `family` names its network,
portbench/reference/nets/<family>.py (the reference's forward) and
portbench/work/nets/<family>.py (its conv table). Adding any of them adds
files and entries; nothing here lists them.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    check: dict           # portbench/checks/<cell>.json


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration,
    traffic, metric entries and limits."""
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have: {', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(root, "portbench", "traffic",
                                      w["traffic"] + ".json"))
    check = _load_json(os.path.join(root, "portbench", "checks",
                                    name + ".json"))
    return Cell(name, config, traffic, int(w["chips"]),
                [m for m in spec["end_to_end"] if _reports(m, name)],
                [m for m in spec["per_layer"] if _reports(m, name)], check)


def load_module(kind: str, name: str, root: str = ROOT):
    """portbench/<kind>/<name>.py as a module (a metric's reader, a
    kernel's work counter, a network: kind "reference/nets" or
    "work/nets"). A missing file raises FileNotFoundError naming it."""
    path = os.path.join(root, "portbench", kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} {name!r}: {path} does not exist")
    mod_name = "".join(c if c.isalnum() else "_"
                       for c in f"portbench_{kind}_{name}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod       # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod
