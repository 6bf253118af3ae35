"""The port's evaluate CLI (posebyte_tpu_torch/cli/evaluate.py) against
the JAX package's on the CPU: --json on an mp4 of the held-out clip of
tests/test_trained_pixels.py (seed 424242, 3 people, 640x360, 24 frames,
rendered by the JAX package's cv2 renderer) with its ground truth,
yolov8n-pose at 256 from assets/, at the CLI's default precision, bf16,
per frame and with --chunk 8.

frames, MOTA, IDF1, id switches, misses and false positives equal JAX's;
OKS-mAP, AP50 and AP75 within MAP_TOL = 0.01 (measured: mAP 0.9099
against 0.9079, AP50 and AP75 equal). bf16 rounds differently in XLA's CPU
convolutions and oneDNN's (tests/test_torch_models.py holds the bf16
forward within 5%), so the keypoints the two packages output differ and
OKS against the ground truth moves with them. On the crowded clip of
tests/test_torch_cli.py the bf16 counts differ too (3 id switches against
JAX's 6, 13 false positives against 12): there the detections near the
threshold flip, and the per-frame ids are held equal in fp32 instead
(tests/test_torch_cli.py). The chunked run gives the per-frame run's
summary.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from posebyte_tpu.models import weights as JW
from posebyte_tpu.models.yolo_pose import init_params
from posebyte_tpu.utils import synthetic as JS
from posebyte_tpu.utils.video import VideoWriter

from posebyte_tpu_torch.cli import evaluate

torch.set_num_threads(4)

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "yolov8n-pose-synthetic256.safetensors")

MAP_TOL = 0.01
COUNTS = ("frames", "MOTA", "IDF1", "id_switches", "misses",
          "false_positives", "matches", "gt")


@pytest.fixture(autouse=True)
def jax_tree_by_shape(monkeypatch):
    monkeypatch.setattr(JW, "init_params", lambda key, name: jax.eval_shape(
        lambda k: init_params(k, name), key))


def _summary(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def write_held_out_clip(path: str) -> np.ndarray:
    scene = JS.SyntheticScene(n_persons=3, width=640, height=360,
                              seed=424242, scale_range=(80.0, 130.0),
                              speed=4.0)
    writer = VideoWriter(path, 640, 360, 30.0)
    gt = []
    for poses in scene.frames(24):
        writer.write(JS.render_frame(poses, 640, 360))
        gt.append(poses.copy())
    writer.release()
    return np.stack(gt)


def test_evaluate_json_matches_jax(tmp_path, capsys):
    from posebyte_tpu.cli import evaluate as jevaluate
    clip, gt = str(tmp_path / "clip.mp4"), str(tmp_path / "gt.npz")
    np.savez(gt, poses=write_held_out_clip(clip))
    argv = ["-e", ASSET, "-i", clip, "-g", gt, "--size", "256", "--json"]
    got = _summary(evaluate.main, argv + ["--device", "cpu"], capsys)
    want = _summary(jevaluate.main, argv, capsys)
    assert got.keys() == want.keys()
    for k in COUNTS:
        assert got[k] == want[k], (k, got, want)
    for k in ("mAP", "AP50", "AP75"):
        assert abs(got[k] - want[k]) <= MAP_TOL, (k, got, want)
    assert got["frames"] == 24 and got["matches"] > 0
    chunked = _summary(evaluate.main, argv + ["--device", "cpu", "--chunk",
                                              "8"], capsys)
    assert chunked == got
    short = _summary(evaluate.main, argv + ["--device", "cpu",
                                            "--max-frames", "10"], capsys)
    assert short["frames"] == 10
