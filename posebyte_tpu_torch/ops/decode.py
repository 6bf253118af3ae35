"""Sparse YOLO-pose decode, after posebyte_tpu/ops/decode.py:70-139
(decode_topk) and its shared tail (_decode_candidate_tail).

The top-K anchors are chosen on confidence first; the DFL softmax and the
keypoint decode then run for those K only. Candidate rows are taken by an
index gather, which gives the values of the JAX package's one-hot gather.
"""
from __future__ import annotations

import functools

import torch

from ..core import constants as C
from ..core.structs import Detections
from ..models.yolo_pose import REG_MAX, _dfl, make_anchors
from .topk import topk_confidence


@functools.lru_cache(maxsize=8)
def _anchor_tensors(input_size: int, device: torch.device):
    anchors, strides = make_anchors(input_size)
    return (torch.from_numpy(anchors).to(device),
            torch.from_numpy(strides).to(device))


def decode_topk(box_logits: torch.Tensor, cls_logits: torch.Tensor,
                kpt_raw: torch.Tensor, conf_threshold: float,
                max_candidates: int, input_size: int,
                topk_impl: str = "sort") -> Detections:
    """Single image: box [A, 64], cls [A, 1], kpt [A, 51] -> a
    score-descending Detections of capacity min(max_candidates, A), with
    the invalid candidates (conf < threshold) at the tail, zeroed."""
    A = box_logits.shape[0]
    conf = torch.sigmoid(cls_logits[:, 0].float())                 # [A]
    ranked = torch.where(conf >= conf_threshold, conf, -1.0)
    k = min(max_candidates, A)
    top_conf, top_idx = topk_confidence(ranked, k, topk_impl)
    valid = top_conf > 0.0

    anchors_all, strides_all = _anchor_tensors(input_size, conf.device)
    anchors = anchors_all[top_idx]                                 # [K, 2]
    strides = strides_all[top_idx]                                 # [K]
    conf_sel = conf[top_idx]
    bl = box_logits[top_idx].float()                               # [K, 64]
    k3 = kpt_raw[top_idx].float().reshape(k, C.NUM_KEYPOINTS, 3)

    d = _dfl(bl.reshape(k, 4, REG_MAX))                            # [K, 4]
    x1y1 = (anchors - d[:, :2]) * strides[:, None]
    x2y2 = (anchors + d[:, 2:]) * strides[:, None]
    boxes = torch.cat([x1y1, x2y2], dim=-1)                        # xyxy

    kxy = (k3[..., :2] * 2.0 + (anchors[:, None, :] - 0.5)) \
        * strides[:, None, None]
    poses = torch.cat([kxy, torch.sigmoid(k3[..., 2:3])], dim=-1)

    z = valid[:, None]
    return Detections(
        poses=torch.where(z[..., None], poses, 0.0),
        boxes=torch.where(z, boxes, 0.0),
        scores=torch.where(valid, conf_sel, 0.0),
        valid=valid,
    )
