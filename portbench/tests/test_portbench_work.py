"""The roofline work counters on inputs sized by hand."""
import numpy as np

from portbench.harness.peaks import least_time
from portbench.work import conv_w8a8, model_flops, nms_keep, tracker_chunk


def test_conv_w8a8_work():
    # 1x1, 4 -> 8 channels, 2x2 pixels: bf16 in 32 B, weights 32 B,
    # scale and bias 64 B, bf16 out 64 B; 2 * 4 * 8 * 4 operations
    assert conv_w8a8.work(4, 8, 1, 1, 2, 2) == (192, 256)


def test_nms_work_counts_pairs_and_covisible_keypoints():
    poses = np.zeros((1, 3, 17, 3), np.float32)
    poses[0, :, :5, 2] = 0.9            # 5 keypoints visible on each
    boxes = np.array([[[0, 0, 10, 10], [0, 0, 10, 10], [50, 50, 60, 60]]],
                     np.float32)
    valid = np.array([[True, True, False]])
    nbytes, ops = nms_keep.work(poses, boxes, valid, 0.55)
    assert nbytes == 3 * 51 * 4 + 3 * 16 + 2 * 3
    # one valid pair; its IoU is 1 > 0.55, so the IoU decides it
    assert ops == 13
    boxes[0, 1] = [20, 20, 30, 30]
    assert nms_keep.work(poses, boxes, valid, 0.55)[1] == 13 + 8 * 5


def test_tracker_work():
    valid = np.array([[True] * 3 + [False], [True] * 2 + [False] * 2])
    nbytes, ops = tracker_chunk.work(valid, np.array([3, 2]), 1, T=8, D=4)
    pair = 30 + 8 * 21
    assert ops == pair * (1 * 3 + 3 * 2) + 20 * (1 + 9)
    state = 8 * tracker_chunk.STATE_BYTES_PER_SLOT + 8 + 16
    assert nbytes == 2 * state + 2 * 4 * 209 + 2 * 4 * 229 + 8


def test_least_time_takes_the_larger_bound():
    assert least_time(3.35e12, 0, 1e12, 3.35e12) == 1.0
    assert least_time(0, 2e12, 1e12, 3.35e12) == 2.0


def test_model_least_time_splits_by_precision():
    cfg = {"family": "v8", "input_size": 64, "depth_multiple": 0.33,
           "width_multiple": 0.25, "max_channels": 1024, "nc": 1,
           "kpt_shape": [17, 3], "reg_max": 16, "quant": None}
    peaks = {"int8_ops_s": 2.0, "bf16_ops_s": 1.0}
    ops = model_flops.forward_ops(cfg)
    assert model_flops.least_time(cfg, peaks) == ops
    q = {**cfg, "quant": {"skip": []}}
    assert model_flops.least_time(q, peaks) == ops / 2
