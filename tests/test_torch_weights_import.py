"""The port's Ultralytics .pt import (posebyte_tpu_torch/models/weights.py:
load_ultralytics_checkpoint, convert_state_dict, load_pretrained) against
posebyte_tpu/models/weights.py on checkpoints written here.

Each .pt holds an Ultralytics-structured module tree (model.{i}.cv1.conv.
weight, ...bn.running_var, the head's plain output convs, YOLO11's C3k2
inner blocks, C2PSA's attn and ffn, the depthwise class branch) whose
classes live in a module that is removed from sys.modules before the load,
as tests/test_weights.py does, so that neither package can import them.
Weights are the trained checkpoints' (assets/), BatchNorm statistics
seeded; tensors are float16, as released .pt files hold them. Tolerance:
none, the port's dict equals the JAX package's converted tree bit for bit
(both fold BatchNorm with the same float32 numpy arithmetic). With
identity statistics (g = 1, mean 0, var = 1 - eps) the fold gives the
checkpoint's float32 weights back within its rounding (1e-6 relative).

The JAX package's convert_state_dict fills init_params' tree, whose random
initialisation alone takes ~20 s on a CPU; the tests give it the same
tree by jax.eval_shape (every leaf is overwritten by its fillers, and a
leaf left unfilled would fail the comparison).
"""
import os
import re
import sys
import types

import jax
import numpy as np
import pytest
import torch

from posebyte_tpu.models import weights as JW
from posebyte_tpu.models.yolo_pose import init_params

from posebyte_tpu_torch.models import weights as W
from posebyte_tpu_torch.models.yolo_pose import MODEL_CONFIGS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = {"yolov8n-pose": "yolov8n-pose-synthetic256.safetensors",
          "yolo11n-pose": "yolo11n-pose-synthetic640.safetensors"}
FAKE = "fake_ultralytics.nn.tasks"


@pytest.fixture(autouse=True)
def jax_tree_by_shape(monkeypatch):
    monkeypatch.setattr(JW, "init_params", lambda key, name: jax.eval_shape(
        lambda k: init_params(k, name), key))


def torch_prefix(key: str, name: str) -> tuple[str, bool]:
    """The port's conv key -> (its Ultralytics module name, whether it is
    a plain nn.Conv2d rather than a Conv with BatchNorm), the inverse of
    the fillers, written from the JAX package's layouts."""
    cfg = MODEL_CONFIGS[name]
    layout = JW._V8_LAYOUT if cfg.family == "v8" else JW._V11_LAYOUT
    top, _, rest = key.partition(".")
    rest = "." + rest if rest else ""
    if top == "head":
        rest = re.sub(r"\.(\d)_dw$", r".\1.0", rest)
        rest = re.sub(r"\.(\d)_pw$", r".\1.1", rest)
        return f"model.{22 if cfg.family == 'v8' else 23}{rest}", \
            rest.endswith(".2")
    idx, kind = {k: (i, kd) for k, i, kd in layout}[top]
    if kind == "c3k2":
        rest = re.sub(r"\.m\.(\d+)\.1\.", r".m.\1.", rest)
    rest = rest.replace(".ffn1", ".ffn.0").replace(".ffn2", ".ffn.1")
    return f"model.{idx}{rest}", False


def ultralytics_sd(flat: dict, name: str, seed: int, identity=False,
                   no_bn=()) -> dict:
    """An Ultralytics state dict whose fold gives `flat`'s convs back:
    conv.weight = w, BatchNorm statistics seeded (or identity), bias
    beta = b. Convs in no_bn keep a conv.bias instead of a BatchNorm."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key in [k[:-2] for k in flat if k.endswith(".w")]:
        w, b = flat[key + ".w"], flat[key + ".b"]
        prefix, plain = torch_prefix(key, name)
        if plain or key in no_bn:
            sub = "" if plain else ".conv"
            sd[f"{prefix}{sub}.weight"], sd[f"{prefix}{sub}.bias"] = w, b
            continue
        c = w.shape[0]
        sd[f"{prefix}.conv.weight"] = w
        if identity:
            g, m = np.ones(c, np.float32), np.zeros(c, np.float32)
            v = np.full(c, 1.0 - JW.BN_EPS, np.float32)
        else:
            g = rng.uniform(0.5, 1.5, c).astype(np.float32)
            m = rng.normal(0, 0.2, c).astype(np.float32)
            v = rng.uniform(0.3, 2.0, c).astype(np.float32)
        sd.update({f"{prefix}.bn.weight": g, f"{prefix}.bn.bias": b,
                   f"{prefix}.bn.running_mean": m,
                   f"{prefix}.bn.running_var": v})
    return sd


def write_pt(path, members: dict, dtype=torch.float16):
    """torch.save a checkpoint {key: module tree of one state dict, or
    another value}; the trees' classes come from a module that is gone
    from sys.modules afterwards."""
    mod = types.ModuleType(FAKE)

    class Node(torch.nn.Module):
        pass

    Node.__module__, Node.__qualname__ = FAKE, "Node"
    mod.Node = Node

    def tree(sd):
        root = Node()
        for n, arr in sd.items():
            *path, leaf = n.split(".")
            m = root
            for part in path:
                if part not in m._modules:
                    m.add_module(part, Node())
                m = m._modules[part]
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
            if leaf.startswith("running_"):
                m.register_buffer(leaf, t)
            else:
                m.register_parameter(leaf, torch.nn.Parameter(
                    t, requires_grad=False))
        return root

    parts = FAKE.split(".")
    names = [".".join(parts[:i]) for i in range(1, len(parts) + 1)]
    for n in names[:-1]:
        sys.modules[n] = types.ModuleType(n)
    sys.modules[FAKE] = mod
    try:
        torch.save({k: tree(v) if isinstance(v, dict) else v
                    for k, v in members.items()}, path)
    finally:
        for n in names:
            del sys.modules[n]
    assert not any(n in sys.modules for n in names)


def jax_flat(path, name):
    return W.params_from_jax(jax.tree.map(np.asarray,
                                          JW.load_pretrained(path, name)))


def assert_bit_equal(got: dict, want: dict):
    assert list(got) and got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype == np.float32, k
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      v.view(np.int32), err_msg=k)


@pytest.mark.parametrize("name", list(ASSETS))
def test_load_pretrained_matches_jax(tmp_path, name):
    """A released .pt (the model under "model", float16): the port's
    load_pretrained equals params_from_jax of the JAX package's, bit for
    bit, and has load_params' keys and shapes."""
    flat, _ = W.load_params(os.path.join(ROOT, "assets", ASSETS[name]))
    sd = ultralytics_sd(flat, name, seed=1, no_bn=("b0",))
    path = str(tmp_path / "released.pt")
    write_pt(path, {"model": sd, "epoch": -1})
    got = W.load_pretrained(path, name)
    assert_bit_equal(got, jax_flat(path, name))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in flat.items()}


def test_training_checkpoint_takes_the_ema(tmp_path):
    """A training checkpoint carries "ema" beside "model": the EMA's
    weights are loaded, by both packages alike (YOLO11, float16)."""
    name = "yolo11n-pose"
    flat, _ = W.load_params(os.path.join(ROOT, "assets", ASSETS[name]))
    ema = ultralytics_sd(flat, name, seed=2)
    model = {k: v * np.float32(0.5) for k, v in ema.items()}
    path = str(tmp_path / "train.pt")
    write_pt(path, {"epoch": 7, "model": model, "ema": ema,
                    "optimizer": None})
    got = W.load_pretrained(path, name)
    assert_bit_equal(got, jax_flat(path, name))
    sd = W.load_ultralytics_checkpoint(path)
    key = "model.10.m.0.attn.pe.conv.weight"
    np.testing.assert_array_equal(
        sd[key], ema[key].astype(np.float16).astype(np.float32))
    assert sd.keys() == JW.load_ultralytics_checkpoint(path).keys()


@pytest.mark.parametrize("name", list(ASSETS))
def test_identity_batchnorm_gives_the_weights_back(tmp_path, name):
    """float32 tensors and identity statistics: the fold returns the
    checkpoint's own weights within the fold's rounding."""
    flat, _ = W.load_params(os.path.join(ROOT, "assets", ASSETS[name]))
    path = str(tmp_path / "identity.pt")
    write_pt(path, {"model": ultralytics_sd(flat, name, 0, identity=True)},
             dtype=torch.float32)
    got = W.load_pretrained(path, name)
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_load_ultralytics_checkpoint_refuses_what_is_no_model(tmp_path):
    path = str(tmp_path / "tensor.pt")
    torch.save(torch.zeros(3), path)
    with pytest.raises(ValueError, match="no tensors"):
        W.load_ultralytics_checkpoint(path)
    torch.save([1, 2], path)
    with pytest.raises(ValueError, match="unrecognized"):
        W.load_ultralytics_checkpoint(path)


def test_convert_state_dict_needs_every_layer():
    """A state dict that lacks a layer of the configuration raises (the
    layer counts come from MODEL_CONFIGS, not from the file)."""
    name = "yolo11n-pose"
    flat, _ = W.load_params(os.path.join(ROOT, "assets", ASSETS[name]))
    sd = ultralytics_sd(flat, name, seed=3)
    W.convert_state_dict(sd, name)
    del sd["model.6.m.0.m.1.cv2.conv.weight"]
    with pytest.raises(KeyError):
        W.convert_state_dict(sd, name)
