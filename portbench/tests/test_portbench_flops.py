"""The benchmark's own operation counter against PyTorch's FLOP counter
over the plain reference's forward, and its conv table against the
checkpoints, for every configuration BENCHMARK.json names."""
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness.spec import ROOT
from portbench.reference import model as M
from portbench.work import model_flops as MF

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    FILES = {c["name"]: c["file"] for c in json.load(f)["configs"]}
CONFIGS = list(FILES)


def _config(name):
    with open(os.path.join(ROOT, FILES[name])) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_table_matches_checkpoint(name):
    cfg = _config(name)
    params = M.read_checkpoint(os.path.join(ROOT, cfg["checkpoint"]))
    shapes = {k[:-2]: tuple(v.shape) for k, v in params.items()
              if k.endswith(".w")}
    table = {c.key: (c.cout, c.cin // c.groups, c.k, c.k)
             for c in MF.conv_table(cfg)}
    assert table == shapes


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_ops_equal_flop_counter(name):
    cfg = _config(name)
    params = M.read_checkpoint(os.path.join(ROOT, cfg["checkpoint"]))
    x = torch.rand(1, 3, cfg["input_size"], cfg["input_size"])
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        M.forward(M.Convs(params, "cpu"), x, cfg["family"])
    assert fc.get_total_flops() == MF.forward_ops(cfg)


def test_quantised_counts():
    """59 quantised convs in yolov8n-pose; 85 in yolo11n-pose, 7 of them
    depthwise (the 78 the int8 kernel runs)."""
    v11 = _config("yolo11n-pose-640-w8a8")
    q = [c for c in MF.conv_table(v11) if MF.is_quantised(v11, c)]
    assert len(q) == 85 and sum(c.groups > 1 for c in q) == 7
    v8 = {**_config("yolov8n-pose-640"), "quant": v11["quant"]}
    assert sum(MF.is_quantised(v8, c) for c in MF.conv_table(v8)) == 59
