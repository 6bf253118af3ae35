"""A network is found by its configuration's family. The two networks the
cells run read as they did before they moved into nets/ files (their
operation counts, conv tables, anchors, the reference's ATen ops and its
heads, pinned below as recorded then), and a new family of four pyramid
levels is taken as new files and BENCHMARK.json entries alone."""
import dataclasses
import hashlib
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import check as CK
from portbench.harness import spec
from portbench.harness.spec import ROOT
from portbench.reference import model as M
from portbench.reference.scene import render_clip
from portbench.work import model_flops as MF

# Recorded before the networks moved into nets/ files. "ops": the ATen
# ops of the reference's forward (name, shapes, dtypes, other arguments),
# in order, at input 128 on two seeded images; "heads": the bytes of its
# heads there, on one CPU thread, which holds only for the PyTorch build
# and CPU kernels in HEADS_RECORDED_ON.
RECORDED = {
    "yolov8n-pose-640": {
        "forward_ops": 9176654400,
        "table": "58686babd08043f61bc28b140166502e"
                 "9ce4a6d677f5649103f61ab8d800f471",
        "ops": "8be2b3cd164f2683a06c74bd5bd24835"
               "31b84899124b24f89c0c32a6925fd4e7",
        "heads": "fdc67600419916085e229f530bf9b922"
                 "da2243061d2bf96cf37a0443fdec65e1"},
    "yolo11n-pose-640-w8a8": {
        "forward_ops": 7465908800,
        "table": "a52093bdd535e08a57399c2048afa915"
                 "83a2782a575bb5fe7dda83d29572f25c",
        "ops": "a45362f9a1da1a80f9a47c54974ca9f3"
               "103a9336e21577e7253601390750ac2d",
        "heads": "76f1c49d34f3b6d5157489e37c0b9ba5"
                 "da5b23e94e49486a446f75d18c453e22"},
}
ANCHORS_640 = ("2ca697ae014b3e37f8928e7ef59fbb38"
               "e609cb0d25f4d4fddc7f498a99125198")
HEADS_RECORDED_ON = ("2.13.0+cpu", "AVX512")
TOY = os.path.join(os.path.dirname(__file__), "toy_nets")
TOY_CELL = "toy4-dev720-c128"


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


class _Ops(TorchDispatchMode):
    """Records every ATen op: its name, its tensors' shapes and dtypes and
    its other arguments."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}

        def desc(a):
            if isinstance(a, torch.Tensor):
                return ("T", tuple(a.shape), str(a.dtype))
            if isinstance(a, (list, tuple)):
                return tuple(desc(x) for x in a)
            return repr(a)

        self.ops.append((str(func), desc(args), desc(sorted(kwargs.items()))))
        return func(*args, **kwargs)


def _small_forward(name):
    """The reference's forward of `name` as its cell runs it (float32, or
    w8a8 calibrated on 4 frames of seed 7) at input 128 on two images of
    seed 0: (digest of its ATen ops, digest of its heads)."""
    cfg = _config(name)
    params = M.read_checkpoint(os.path.join(ROOT, cfg["checkpoint"]))
    small = {**cfg, "input_size": 128}
    if cfg.get("quant"):
        small["quant"] = {**cfg["quant"], "calibration_frames": 4}
    convs = CK.reference_convs(small, params, 7, torch.device("cpu"))
    x = torch.rand(2, 3, 128, 128, generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), _Ops() as rec:
        heads = M.forward(convs, x, cfg["family"])
    return (_sha(repr(rec.ops).encode()),
            _sha(b"".join(h.contiguous().numpy().tobytes() for h in heads)))


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_counts_as_before(name):
    cfg = _config(name)
    assert MF.forward_ops(cfg) == RECORDED[name]["forward_ops"]
    table = repr([dataclasses.astuple(c) for c in MF.conv_table(cfg)])
    assert _sha(table.encode()) == RECORDED[name]["table"]
    xy, strides = M.anchors(640, "cpu", cfg["family"])
    assert _sha(xy.numpy().tobytes() + strides.numpy().tobytes()) \
        == ANCHORS_640


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_reference_ops_as_before(name):
    assert _small_forward(name)[0] == RECORDED[name]["ops"]


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_reference_heads_as_before(name):
    here = (torch.__version__, torch.backends.cpu.get_cpu_capability())
    if here != HEADS_RECORDED_ON:
        pytest.skip(f"the heads' bytes were recorded with PyTorch "
                    f"{HEADS_RECORDED_ON[0]} on {HEADS_RECORDED_ON[1]} CPU "
                    f"kernels, not {here}; the ops digest stands")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert _small_forward(name)[1] == RECORDED[name]["heads"]
    finally:
        torch.set_num_threads(threads)


# ------------------------------------------------- a new family as files

def _digests(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = _sha(fh.read())
    return out


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    """A root with the benchmark's files and one new family, "toy4" (four
    levels, strides 8 to 64), added as its two network files, a
    configuration and a cell: new files and entries, and no file that was
    there edited."""
    root = tmp_path_factory.mktemp("toyroot")
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    before = _digests(root)
    before.pop("BENCHMARK.json")
    shutil.copy(os.path.join(TOY, "reference.py"),
                root / "portbench/reference/nets/toy4.py")
    shutil.copy(os.path.join(TOY, "work.py"),
                root / "portbench/work/nets/toy4.py")
    cfg = {**_config("yolov8n-pose-640"), "name": "toy4-pose-128",
           "family": "toy4", "input_size": 128, "checkpoint": None,
           "precision": "int8",
           "quant": {**_config("yolo11n-pose-640-w8a8")["quant"],
                     "calibration_frames": 2}}
    (root / "portbench/configs/toy4-pose-128.json").write_text(
        json.dumps(cfg))
    shutil.copy(root / "portbench/checks/v8n-bf16-dev720-c128.json",
                root / f"portbench/checks/{TOY_CELL}.json")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "toy4-pose-128", "source": "x",
                           "reduced": [], "why": "x",
                           "file": "portbench/configs/toy4-pose-128.json"})
    new["workloads"].append({"name": TOY_CELL, "config": "toy4-pose-128",
                             "traffic": "devclip-720p-6p-c128", "chips": 1,
                             "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    after = _digests(root)
    assert {k: after[k] for k in before} == before
    for key in bench:
        if isinstance(bench[key], list):
            assert new[key][:len(bench[key])] == bench[key]
    return str(root)


def _toy(root):
    """The toy cell's configuration, model_flops as the run loads it from
    the root, and random weights of the shapes of its conv table."""
    cfg = spec.load_cell(TOY_CELL, root).config
    mf = spec.load_module("work", "model_flops", root)
    rng = np.random.default_rng(0)
    params = {}
    for c in mf.conv_table(cfg):
        fan_in = c.cin // c.groups * c.k * c.k
        params[c.key + ".w"] = (rng.standard_normal(
            (c.cout, c.cin // c.groups, c.k, c.k))
            / np.sqrt(fan_in)).astype(np.float32)
        params[c.key + ".b"] = np.zeros(c.cout, np.float32)
    return cfg, mf, params


def test_toy_family_runs_the_reference_path(toy_root):
    """run.py's reference path (calibration, forward, anchors, decode,
    NMS) finds the new family under the run's root."""
    cfg, _, params = _toy(toy_root)
    convs = CK.reference_convs(cfg, params, 3, torch.device("cpu"),
                               root=toy_root)
    clip = render_clip(2, 256, 144, 6, 3)
    dets = CK.reference_detections(cfg, convs, clip, torch.device("cpu"),
                                   root=toy_root)
    assert len(dets) == 2


def test_toy_heads_have_a_row_an_anchor(toy_root):
    cfg, _, params = _toy(toy_root)
    S = cfg["input_size"]
    rows = sum((S // s) ** 2 for s in (8, 16, 32, 64))
    x = torch.rand(1, 3, S, S, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        box, cls, kp = M.forward(M.Convs(params, "cpu"), x, "toy4", toy_root)
    assert (box.shape, cls.shape, kp.shape) == (
        (1, rows, 64), (1, rows, 1), (1, rows, 51))
    xy, strides = M.anchors(S, "cpu", "toy4", toy_root)
    assert xy.shape == (rows, 2) and int(strides.max()) == 64


def test_toy_forward_ops_equal_flop_counter(toy_root):
    cfg, mf, params = _toy(toy_root)
    S = cfg["input_size"]
    x = torch.rand(1, 3, S, S)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        M.forward(M.Convs(params, "cpu"), x, "toy4", toy_root)
    assert fc.get_total_flops() == mf.forward_ops(cfg)


def test_unknown_family_names_the_file(toy_root):
    cfg, mf, params = _toy(toy_root)
    cfg = {**cfg, "family": "nosuch"}
    ref = os.path.join(toy_root, "portbench", "reference", "nets", "nosuch.py")
    work = os.path.join(toy_root, "portbench", "work", "nets", "nosuch.py")
    x = torch.rand(1, 3, 128, 128)
    with pytest.raises(FileNotFoundError, match=re.escape(ref)):
        M.forward(M.Convs(params, "cpu"), x, "nosuch", toy_root)
    with pytest.raises(FileNotFoundError, match=re.escape(ref)):
        M.anchors(128, "cpu", "nosuch", toy_root)
    with pytest.raises(FileNotFoundError, match=re.escape(work)):
        mf.conv_table(cfg)
