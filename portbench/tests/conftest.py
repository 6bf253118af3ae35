"""Fixtures of the benchmark's CPU tests: a checkout root of their own
with a tiny traffic mix, so that a whole run fits a test."""
import json
import os
import shutil

import pytest

from portbench.harness.spec import ROOT

TINY = {"name": "tiny", "width": 640, "height": 360, "clip_frames": 4,
        "chunk": 4, "warmup_chunks": 1,
        "check": {"start_chunks": 2, "sample_below": 4,
                  "sampled_chunks": 1, "last_chunk": True}}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A root holding BENCHMARK.json with every cell on the traffic "tiny"
    (the first cell's mix at 640x360, chunks of 4 frames), the first cell
    once more as "host-tiny" on the same mix fed from host memory, the
    benchmark's files and the checkpoints."""
    root = tmp_path_factory.mktemp("root")
    bench = root / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "assets"), root / "assets")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(bench / "traffic" / f"{spec['workloads'][0]['traffic']}.json") \
            as f:
        traffic = {**json.load(f), **TINY}
    for w in spec["workloads"]:
        w["traffic"] = "tiny"
    with open(bench / "traffic" / "tiny.json", "w") as f:
        json.dump(traffic, f)
    # the same mix fed from host memory (process_chunk)
    with open(bench / "traffic" / "tiny-host.json", "w") as f:
        json.dump({**traffic, "name": "tiny-host", "frames_on": "host"}, f)
    spec["workloads"].append({**spec["workloads"][0], "name": "host-tiny",
                              "traffic": "tiny-host"})
    shutil.copy(bench / "checks" / f"{spec['workloads'][0]['name']}.json",
                bench / "checks" / "host-tiny.json")
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(spec, f)
    return str(root)
