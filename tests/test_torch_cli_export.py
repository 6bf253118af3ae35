"""The port's export CLI (posebyte_tpu_torch/cli/export.py) against the JAX
package on the CPU, on assets/yolov8n-pose-synthetic256.safetensors:

- bf16 and int8 exports read back through both packages' load_params with
  equal tensors;
- int8 calibrated from a directory of PNGs written here (JAX-rendered
  frames of the held-out scene): the images equal to the JAX package's
  _load_calibration_images within 1e-6 (the normalised letterbox's
  XLA-versus-PyTorch rounding), the activation scales within 1e-4 relative
  of posebyte_tpu.models.quant.calibrate_and_quantize on the same
  directory (ROADMAP Queue 3, "Percentile calibration", says why not bit
  for bit);
- a --calib-cache written by either package read by the other.

The JAX package's load_params builds its tree with init_params, whose
random initialisation is replaced here by jax.eval_shape (every leaf is
overwritten from the file).
"""
import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from posebyte_tpu.models import quant as JQ
from posebyte_tpu.models import weights as JW
from posebyte_tpu.models.yolo_pose import init_params
from posebyte_tpu.utils import synthetic as JS

from posebyte_tpu_torch.cli import export
from posebyte_tpu_torch.models import quant as Q
from posebyte_tpu_torch.models import weights as W

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "assets", "yolov8n-pose-synthetic256.safetensors")
NAME = "yolov8n-pose"
RTOL = 1e-4


@pytest.fixture(autouse=True)
def jax_tree_by_shape(monkeypatch):
    monkeypatch.setattr(JW, "init_params", lambda key, name: jax.eval_shape(
        lambda k: init_params(k, name), key))


def _port_from_jax(path):
    """A file read by the JAX package's load_params, in the port's flat
    layout."""
    tree, name = JW.load_params(path)
    assert name == NAME
    return W.params_from_jax(jax.tree.map(np.asarray, tree))


def _assert_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        g = np.asarray(got[k])
        assert g.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)


def _scales(flat: dict) -> dict:
    return {p: float(np.asarray(flat[k + ".act_scale"]))
            for p, k in Q.conv_paths(flat).items()
            if k + ".act_scale" in flat}


def _jax_scales(tree) -> dict:
    return {p: float(np.asarray(n["act_scale"]))
            for p, n in JQ.conv_paths(tree).items() if "act_scale" in n}


@pytest.fixture(scope="module")
def calib_dir(tmp_path_factory):
    """Four frames of the held-out scene as PNGs, and a file that is not
    an image (skipped, as cv2.imread skips it in the JAX package)."""
    d = tmp_path_factory.mktemp("calib")
    scene = JS.SyntheticScene(n_persons=3, width=640, height=360,
                              seed=424242, scale_range=(80.0, 130.0))
    for i, gt in enumerate(scene.frames(4)):
        cv2.imwrite(str(d / f"f{i}.png"), JS.render_frame(gt, 640, 360))
    (d / "notes.txt").write_text("not an image")
    return str(d)


@pytest.mark.parametrize("precision", ["bf16", "fp16", "int8"])
def test_export_reads_back_through_both_packages(tmp_path, capsys,
                                                 precision):
    out = str(tmp_path / f"{precision}.safetensors")
    argv = ["-m", ASSET, "-o", out, "-p", precision, "--size", "64",
            "--device", "cpu"]
    if precision == "int8":
        argv.append("--allow-synthetic-calib")
    assert export.main(argv) == 0
    printed = capsys.readouterr().out
    assert "warm forward (1x64, cpu)" in printed
    port, name = W.load_params(out)
    assert name == NAME
    _assert_equal(_port_from_jax(out), port)
    if precision != "int8":
        _assert_equal(port, W.load_params(ASSET)[0])
        return
    assert "(int8)" in printed
    want = Q.quantize_params(W.load_params(ASSET)[0])
    for k in want:
        if not k.endswith(".act_scale"):
            np.testing.assert_array_equal(port[k], want[k], err_msg=k)
    assert len(_scales(port)) == 59


def test_export_int8_calibrates_from_images_as_jax(tmp_path, calib_dir):
    got_imgs = Q._load_calibration_images(calib_dir, 256)
    want_imgs = JQ._load_calibration_images(calib_dir, 256)
    assert got_imgs.shape == want_imgs.shape == (4, 256, 256, 3)
    np.testing.assert_allclose(got_imgs, want_imgs, rtol=0, atol=1e-6)

    out = str(tmp_path / "int8.safetensors")
    cache = str(tmp_path / "port_cache.json")
    assert export.main(["-m", ASSET, "-o", out, "-p", "int8", "-c",
                        calib_dir, "--size", "256", "--calib-cache", cache,
                        "--device", "cpu", "--no-compile"]) == 0
    got = _scales(W.load_params(out)[0])
    jparams, _ = JW.load_params(ASSET)
    want = _jax_scales(JQ.calibrate_and_quantize(jparams, NAME, calib_dir,
                                                 256))
    assert got.keys() == want.keys() and len(got) == 59
    for p, v in want.items():
        assert abs(got[p] - v) <= RTOL * v, (p, got[p], v)

    # the port's cache, read by the JAX package
    jq = JQ.quantize_params(jparams)
    assert JQ.load_calibration_cache(jq, cache) == 59
    assert _jax_scales(jq) == {p: float(np.float32(v))
                               for p, v in got.items()}


def test_export_reads_a_jax_calibration_cache(tmp_path):
    """A cache written by the JAX package: the port's export attaches its
    scales without calibrating, each equal to the cache's."""
    jparams, _ = JW.load_params(ASSET)
    jq = JQ.quantize_params(jparams)
    rng = np.random.default_rng(3)
    for node in JQ.conv_paths(jq).values():
        if "scale" in node:
            node["act_scale"] = np.float32(rng.uniform(0.01, 0.2))
    cache = str(tmp_path / "jax_cache.json")
    assert JQ.save_calibration_cache(jq, cache) == 59
    out = str(tmp_path / "int8.safetensors")
    assert export.main(["-m", ASSET, "-o", out, "-p", "int8",
                        "--calib-cache", cache, "--device", "cpu",
                        "--no-compile"]) == 0
    with open(cache) as f:
        want = json.load(f)["act_scales"]
    got = _scales(W.load_params(out)[0])
    assert got == {p: float(np.float32(v)) for p, v in want.items()}
