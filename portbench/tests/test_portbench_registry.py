"""BENCHMARK.json and the data files it names: every name resolves to its
file, and a new configuration, traffic mix, metric and cell are found by
name with no file that exists edited."""
import json
import os
import re
import shutil

import pytest

from portbench.harness import spec
from portbench.harness.check import NAMES
from portbench.harness.context import Context
from portbench.harness.spec import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_reader_matches_entry(m):
    mod = spec.load_module("metrics", m["name"])
    assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    if m in BENCH["per_layer"]:
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    cell = spec.load_cell(w["name"])
    assert cell.config["name"] == w["config"]
    assert cell.traffic["name"] == w["traffic"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "fps"}
    assert cell.per_layer and cell.check["limits"]
    assert set(cell.check["limits"]) <= set(NAMES)
    assert all(NAME.match(x) for x in (w["name"], w["config"],
                                       w["traffic"]))


def test_new_files_found_by_name(tmp_path):
    """A later change adds a configuration, a traffic mix, a metric and a
    cell as files and BENCHMARK.json entries; the harness finds them."""
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.load(open(root / "portbench/configs/yolov8n-pose-640.json"))
    cfg["name"] = "yolov8n-pose-640-w8a8"
    (root / "portbench/configs/yolov8n-pose-640-w8a8.json").write_text(
        json.dumps(cfg))
    tr = json.load(open(root / "portbench/traffic/devclip-720p-6p-c128.json"))
    tr.update(name="devclip-1080p-6p-c128", width=1920, height=1080)
    (root / "portbench/traffic/devclip-1080p-6p-c128.json").write_text(
        json.dumps(tr))
    (root / "portbench/checks/v8n-int8-dev1080-c128.json").write_text(
        json.dumps({"limits": {}}))
    (root / "portbench/metrics/frames_per_chunk.py").write_text(
        "UNIT = 'frames'\nSOURCE = 'host_clock'\n"
        "def read(ctx):\n    return ctx.frames / len(ctx.chunks)\n")
    bench["configs"].append({"name": "yolov8n-pose-640-w8a8",
                             "source": "x", "reduced": [], "why": "x",
                             "file": "portbench/configs/"
                                     "yolov8n-pose-640-w8a8.json"})
    bench["workloads"].append({"name": "v8n-int8-dev1080-c128",
                               "config": "yolov8n-pose-640-w8a8",
                               "traffic": "devclip-1080p-6p-c128",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_per_chunk", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "fps",
                               "workloads": ["v8n-int8-dev1080-c128"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("v8n-int8-dev1080-c128", str(root))
    assert cell.config["name"] == "yolov8n-pose-640-w8a8"
    assert cell.traffic["width"] == 1920
    assert "frames_per_chunk" in [m["name"] for m in cell.per_layer]
    old = spec.load_cell("v8n-bf16-dev720-c128", str(root))
    assert "frames_per_chunk" not in [m["name"] for m in old.per_layer]
    reader = spec.load_module("metrics", "frames_per_chunk", str(root))
    ctx = Context(cell.config, cell.traffic, 1.0, 0.0,
                  [(0.0, 0.1, 0.2, 128)] * 3, range(0), root=str(root))
    assert reader.read(ctx) == 128
