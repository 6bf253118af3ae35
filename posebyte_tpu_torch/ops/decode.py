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
    """Box [..., A, 64], cls [..., A, 1], kpt [..., A, 51] -> a
    score-descending Detections of capacity min(max_candidates, A) per
    image, with the invalid candidates (conf < threshold) at the tail,
    zeroed. Leading axes are images (a chunk's K frames: the counterpart
    of the JAX package's vmap over decode_topk)."""
    A = box_logits.shape[-2]
    lead = box_logits.shape[:-2]
    conf = torch.sigmoid(cls_logits[..., 0].float())               # [.., A]
    ranked = torch.where(conf >= conf_threshold, conf, -1.0)
    k = min(max_candidates, A)
    top_conf, top_idx = topk_confidence(ranked, k, topk_impl)
    valid = top_conf > 0.0

    anchors_all, strides_all = _anchor_tensors(input_size, conf.device)
    anchors = anchors_all[top_idx]                                # [.., k, 2]
    strides = strides_all[top_idx]                                # [.., k]
    conf_sel = conf.gather(-1, top_idx)
    rows = top_idx[..., None]
    bl = box_logits.gather(-2, rows.expand(*lead, k, box_logits.shape[-1])).float()
    k3 = kpt_raw.gather(-2, rows.expand(*lead, k, kpt_raw.shape[-1])).float() \
        .reshape(*lead, k, C.NUM_KEYPOINTS, 3)

    d = _dfl(bl.reshape(*lead, k, 4, REG_MAX))                    # [.., k, 4]
    x1y1 = (anchors - d[..., :2]) * strides[..., None]
    x2y2 = (anchors + d[..., 2:]) * strides[..., None]
    boxes = torch.cat([x1y1, x2y2], dim=-1)                       # xyxy

    kxy = (k3[..., :2] * 2.0 + (anchors[..., None, :] - 0.5)) \
        * strides[..., None, None]
    poses = torch.cat([kxy, torch.sigmoid(k3[..., 2:3])], dim=-1)

    z = valid[..., None]
    return Detections(
        poses=torch.where(z[..., None], poses, 0.0),
        boxes=torch.where(z, boxes, 0.0),
        scores=torch.where(valid, conf_sel, 0.0),
        valid=valid,
    )
