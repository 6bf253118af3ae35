"""The port's trainers (posebyte_tpu_torch/scripts/train_synthetic.py and
train_reid.py) against the JAX package's scripts/ on the CPU.

Data: the host letterbox bit for bit; make_split's and make_pairs' labels
bit for bit (the same draws of the same generator); their images come
from two renderers (the port's numpy one, the JAX package's cv2 one),
which differ at a few edge pixels, so the images are compared by the
share of pixels that differ. Metrics: eval_detection's OKS-mAP of the
trained v8n-256 checkpoint and eval_separation of the trained head, each
on the same data in both packages, equal to 1e-6; info_nce_loss and its
gradients on the same batch within 1e-5 / 1e-4 relative. The checkpoint
check (save_params_verified) on a good file and on a file changed after
it was written; both mains end to end at a tiny size.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posebyte_tpu.models import weights as JW
from posebyte_tpu.models.reid_head import load_reid_head as j_load_head
from posebyte_tpu.models.yolo_pose import init_params as j_init_params

from posebyte_tpu_torch.models.reid_head import load_reid_head
from posebyte_tpu_torch.models.train import trainable_params
from posebyte_tpu_torch.models.weights import load_params
from posebyte_tpu_torch.models.yolo_pose import init_params
from posebyte_tpu_torch.scripts import train_reid as TR
from posebyte_tpu_torch.scripts import train_synthetic as TS

from test_torch_quant import jax_tree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
ASSETS = os.path.join(REPO, "assets")
V8_256 = os.path.join(ASSETS, "yolov8n-pose-synthetic256.safetensors")
HEAD = os.path.join(ASSETS, "reid-head-synthetic.safetensors")


@pytest.fixture(autouse=True)
def jax_tree_by_shape(monkeypatch):
    """JAX load_params builds its tree by init_params; its random draws are
    overwritten from the file, so eval_shape stands in (20 s saved)."""
    monkeypatch.setattr(JW, "init_params", lambda key, name: jax.eval_shape(
        lambda k: j_init_params(k, name), key))


@pytest.fixture(scope="module")
def jts():
    import train_synthetic
    return train_synthetic


@pytest.fixture(scope="module")
def jtr():
    import train_reid
    return train_reid


def test_letterbox_host_matches_jax(jts):
    rng = np.random.default_rng(0)
    for w, h in TS.GEOMETRIES + [(333, 517)]:
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for target in (64, 256):
            np.testing.assert_array_equal(TS.letterbox_host(frame, target),
                                          jts.letterbox_host(frame, target))


@pytest.mark.parametrize("noise", [False, True])
def test_make_split_matches_jax(jts, noise):
    got = TS.make_split(24, 96, 777_000, noise=noise)
    want = jts.make_split(24, 96, 777_000, noise=noise)
    for k in ("poses", "boxes", "valid"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["valid"].any() and not got["valid"].all()
    diff = np.any(got["img"] != want["img"], axis=-1).mean()
    assert diff < (0.1 if noise else 0.01), diff


def test_eval_detection_matches_jax(jts):
    """The trained checkpoint on the script's validation split (its first
    32 frames, rendered once and given to both): the same mAP."""
    val = TS.make_split(32, 256, 777_000, noise=False)
    flat, name = load_params(V8_256)
    got = TS.eval_detection(flat, val, name, 256, device="cpu")
    want = jts.eval_detection(jax_tree(flat, name), val, name, 256)
    assert set(got) == set(want) == {"mAP", "AP50", "AP75"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert got["mAP"] > 0.8
    # tensors on a device are taken as they are
    again = TS.eval_detection(trainable_params(flat), val, name, 256,
                              device="cpu")
    assert again == got


def test_save_params_verified(tmp_path, monkeypatch):
    """The saved file's CPU loss equals the device's; a file that differs
    from the params in memory (one weight changed as it is written) is
    refused."""
    name, size = "yolov8n-pose", 64
    params = trainable_params(init_params(0, name))
    out = str(tmp_path / "m.safetensors")
    pm, cpu, dev = TS.save_params_verified(params, out, name, size, 0, 30.0)
    assert cpu == dev
    loaded, meta = load_params(out)
    assert meta == name and all(np.array_equal(loaded[k], pm[k]) for k in pm)
    jp, jname = JW.load_params(out)              # the JAX package reads it
    assert jname == name

    from posebyte_tpu_torch.models import weights as W
    real = W.save_params

    def scrambled(p, path, n):
        p = dict(p)
        p["head.cv3.0.2.b"] = p["head.cv3.0.2.b"] + 3.0
        real(p, path, n)

    monkeypatch.setattr(W, "save_params", scrambled)
    with pytest.raises(RuntimeError, match="disagrees"):
        TS.save_params_verified(params, out, name, size, 0, 30.0)


def test_train_synthetic_main(tmp_path, capsys):
    out = str(tmp_path / "m.safetensors")
    tiny = ["--size", "64", "--steps", "4", "--segment", "2", "--batch",
            "4", "--n-train", "8", "--n-val", "32", "--device", "cpu",
            "--out", out]
    assert TS.main(tiny) == 0
    log = capsys.readouterr().out
    assert "step      4/4" in log and "[save-verify]" in log
    with open(out.replace(".safetensors", ".metrics.json")) as f:
        metrics = json.load(f)
    assert set(metrics) == {"val_detection", "steps", "train_frames",
                            "size", "model"}
    assert metrics["steps"] == 4 and metrics["model"] == "yolov8n-pose"
    assert TS.main(tiny + ["--resume", out]) == 0
    assert "resumed from" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="divide"):
        TS.main(tiny + ["--dp", "3"])


def test_make_pairs_and_info_nce_match_jax(jtr):
    got = TR.make_pairs(4, 128, 11)
    want = jtr.make_pairs(4, 128, 11)
    for k in ("poses_a", "poses_b", "valid"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("img_a", "img_b"):
        assert np.any(got[k] != want[k], axis=-1).mean() < 0.1
    # the loss and its gradients on the same batch (JAX's images)
    head = load_reid_head(HEAD)
    jhead = j_load_head(HEAD)
    jloss, jgrads = jax.jit(jax.value_and_grad(jtr.info_nce_loss))(
        jhead, {k: jnp.asarray(v) for k, v in want.items()})
    leaves = {k: v.clone().requires_grad_(True) for k, v in head.items()}
    loss = TR.info_nce_loss(leaves, {k: torch.from_numpy(v)
                                     for k, v in want.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    for k in head:
        g = np.asarray(jgrads[k])
        np.testing.assert_allclose(leaves[k].grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max())


def test_eval_separation_matches_jax(jtr):
    val = jtr.make_pairs(4, 256, 999_000)
    got = TR.eval_separation(load_reid_head(HEAD), val, device="cpu")
    want = jtr.eval_separation(j_load_head(HEAD), val)
    assert got["anchors"] == want["anchors"] > 0
    assert got["top1_acc"] == want["top1_acc"]
    for k in ("same_id_cos", "diff_id_cos"):
        assert abs(got[k] - want[k]) < 1e-6, k


def test_train_reid_main(tmp_path, capsys):
    out = str(tmp_path / "head.safetensors")
    assert TR.main(["--size", "64", "--steps", "200", "--batch", "4",
                    "--n-train", "8", "--n-val", "4", "--device", "cpu",
                    "--out", out]) == 0
    assert "step   200/200" in capsys.readouterr().out
    with open(out.replace(".safetensors", ".metrics.json")) as f:
        metrics = json.load(f)
    assert set(metrics) == {"val", "steps", "train_pairs", "size"}
    assert set(metrics["val"]) == {"same_id_cos", "diff_id_cos",
                                   "top1_acc", "anchors"}
    assert set(j_load_head(out)) == {"w1", "b1", "w2", "b2"}
