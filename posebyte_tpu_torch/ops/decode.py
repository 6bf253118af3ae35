"""YOLO-pose decode, after posebyte_tpu/ops/decode.py:
- decode_topk (:70-139): the sparse decode. The top-K anchors are chosen
  on confidence first; the DFL softmax and the keypoint decode then run
  for those K only.
- decode_topk_levels (:145-238): the same candidates chosen per pyramid
  level on the head maps before any concatenation
  (DetectorConfig.decode_fusion="tail"), then merged exactly.
- _decode_candidate_tail (:243-273): the per-candidate tail both share.
- decode_yolo_output and decode_yolo_output_batch (:26-63): the dense
  [56, A] output of forward_raw (the reference engine's tensor) -> top-K
  candidates.

Candidate rows are taken by index gathers for both values of gather_impl
("index" and "onehot"): an index gather gives the values of the JAX
package's one-hot selection matmul (ops/topk.py::onehot_select), except in
the subnormal corner decode_topk's docstring describes.
"""
from __future__ import annotations

import functools

import torch

from ..core import constants as C
from ..core.structs import Detections
from ..models.yolo_pose import REG_MAX, _dfl, anchor_tensors, \
    make_anchors_levels
from .topk import topk_confidence, total_order_key

GATHER_IMPLS = ("index", "onehot")


@functools.lru_cache(maxsize=8)
def _level_anchor_tensors(input_size: int, device: torch.device):
    """Per level: [A_l, 3] float32 (anchor x, anchor y, stride)."""
    return tuple(torch.cat([torch.from_numpy(a),
                            torch.from_numpy(s)[:, None]], dim=1).to(device)
                 for a, s in make_anchors_levels(input_size))


def _check_gather(gather_impl: str):
    if gather_impl not in GATHER_IMPLS:
        raise ValueError(f"unknown gather_impl {gather_impl!r} "
                         "(expected index|onehot)")


def _take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [..., A, C] at rows idx [..., k] -> [..., k, C]."""
    return t.gather(-2, idx[..., None].expand(*idx.shape, t.shape[-1]))


def _decode_candidate_tail(valid, conf_sel, bl, kpt_sel, anchors,
                           strides) -> Detections:
    """The per-candidate tail of both selection paths (DFL softmax
    expectation, box assembly, keypoint decode, validity masking) on the
    candidate rows: valid, conf_sel, strides [..., k], bl [..., k, 64]
    float32, kpt_sel [..., k, 51] float32, anchors [..., k, 2]."""
    lead_k = valid.shape
    d = _dfl(bl.reshape(*lead_k, 4, REG_MAX))                     # [.., k, 4]
    x1y1 = (anchors - d[..., :2]) * strides[..., None]
    x2y2 = (anchors + d[..., 2:]) * strides[..., None]
    boxes = torch.cat([x1y1, x2y2], dim=-1)                       # xyxy

    k3 = kpt_sel.reshape(*lead_k, C.NUM_KEYPOINTS, 3)
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


def decode_topk(box_logits: torch.Tensor, cls_logits: torch.Tensor,
                kpt_raw: torch.Tensor, conf_threshold: float,
                max_candidates: int, input_size: int,
                topk_impl: str = "sort",
                gather_impl: str = "index") -> Detections:
    """Box [..., A, 64], cls [..., A, 1], kpt [..., A, 51] -> a
    score-descending Detections of capacity min(max_candidates, A) per
    image, with the invalid candidates (conf < threshold) at the tail,
    zeroed. Leading axes are images (a chunk's K frames: the counterpart
    of the JAX package's vmap over decode_topk).

    topk_impl: "sort", "bisect" (bit-identical) or "approx" (exact off the
    TPU), ops/topk.py. gather_impl: "index" or "onehot"; the port gathers
    by index for both. JAX's one-hot matmul on the TPU flushes a subnormal
    payload entry to zero, which its consumers round to the same result
    (exp(x) == 1 and sigmoid(x) == 0.5 in float32 for |x| < 2^-126) except
    for a subnormal keypoint-xy logit at an anchor offset of exactly 0.5,
    which moves that keypoint by < 2e-38 px; the index gather keeps the
    subnormal, as JAX's own "index" path and its CPU matmul do."""
    _check_gather(gather_impl)
    A = box_logits.shape[-2]
    conf = torch.sigmoid(cls_logits[..., 0].float())               # [.., A]
    ranked = torch.where(conf >= conf_threshold, conf, -1.0)
    k = min(max_candidates, A)
    top_conf, top_idx = topk_confidence(ranked, k, topk_impl)
    valid = top_conf > 0.0

    anchors_all, strides_all = anchor_tensors(input_size, conf.device)
    return _decode_candidate_tail(
        valid, conf.gather(-1, top_idx),
        _take_rows(box_logits, top_idx).float(),
        _take_rows(kpt_raw, top_idx).float(),
        anchors_all[top_idx], strides_all[top_idx])


def decode_topk_levels(levels, conf_threshold: float, max_candidates: int,
                       input_size: int, topk_impl: str = "sort",
                       gather_impl: str = "onehot") -> Detections:
    """The tail-fused sparse decode: `levels` is forward_head_maps' output,
    one (box [..., A_l, 64], cls [..., A_l, 1], kpt [..., A_l, 51]) per
    pyramid level in stride order, leading axes images. Per level the
    confidence ranking keeps its top min(K, A_l) and gathers their payload
    rows [anchor x, anchor y, stride, conf, 64 box logits, 51 keypoint
    values] (the kept rows only, never the whole level's); the <= 3K
    survivors are merged by one sort of the composite
    int64 key (-total-order key) * 2^32 + global anchor index, which is
    lax.top_k's (descending value, ascending index) order on the
    concatenated ranking, and the first K rows feed the shared tail.

    Exact: an anchor outside its level's top K has K anchors of its level
    ahead of it, so it is not in the global top K. The Detections equal
    decode_topk's on the concatenated levels bit for bit, for topk_impl
    "sort", "bisect" and "approx" (exact here) and both gather_impls,
    including the all-filler tail when fewer than K anchors pass."""
    _check_gather(gather_impl)
    per = _level_anchor_tensors(input_size, levels[0][0].device)
    if len(per) != len(levels):
        raise ValueError(f"expected {len(per)} levels, got {len(levels)}")
    k = min(max_candidates, sum(b.shape[-2] for b, _, _ in levels))

    tc_parts, gidx_parts, pay_parts = [], [], []
    offset = 0
    for (bl_l, cls_l, kpt_l), anch in zip(levels, per):
        A_l = bl_l.shape[-2]
        conf = torch.sigmoid(cls_l[..., 0].float())               # [.., A_l]
        ranked = torch.where(conf >= conf_threshold, conf, -1.0)
        tc, ti = topk_confidence(ranked, min(k, A_l), topk_impl)
        # the payload rows of the kept anchors only (JAX's payload gather)
        tc_parts.append(tc)
        gidx_parts.append(ti + offset)
        pay_parts.append(torch.cat(
            [anch[ti], conf.gather(-1, ti)[..., None],
             _take_rows(bl_l, ti).float(), _take_rows(kpt_l, ti).float()],
            dim=-1))                                              # [.., kl, 119]
        offset += A_l

    tc_m = torch.cat(tc_parts, dim=-1)                            # [.., M]
    pos = _merge_order(tc_m, torch.cat(gidx_parts, dim=-1), k)
    rows = _take_rows(torch.cat(pay_parts, dim=-2), pos)          # [.., k, 119]
    valid = tc_m.gather(-1, pos) > 0.0
    return _decode_candidate_tail(valid, rows[..., 3], rows[..., 4:68],
                                  rows[..., 68:], rows[..., :2],
                                  rows[..., 2])


def _merge_order(values: torch.Tensor, gidx: torch.Tensor, k: int):
    """Positions of the first k merged candidates in (descending
    total-order key of values, ascending global index) order."""
    comp = (-total_order_key(values).to(torch.int64)) * (1 << 32) + gidx
    return torch.sort(comp, dim=-1).indices[..., :k]


def decode_yolo_output(raw: torch.Tensor, conf_threshold: float,
                       max_candidates: int = 256) -> Detections:
    """Dense output [..., 56, A] (forward_raw's: rows 0-3 box cxcywh, row 4
    confidence, rows 5-55 the 17 decoded keypoints) -> the top
    min(max_candidates, A) anchors by confidence among those >=
    conf_threshold, as a padded Detections: boxes xyxy, poses [K, 17, 3]
    (reference: kernelDecodeAndFilter, gpu_postprocess.cu:49-80). Leading
    axes are images."""
    A = raw.shape[-1]
    lead = raw.shape[:-2]
    conf = raw[..., 4, :]                                         # [.., A]
    ranked = torch.where(conf >= conf_threshold, conf, -1.0)
    k = min(max_candidates, A)
    top_conf, top_idx = topk_confidence(ranked, k, "sort")
    valid = top_conf > 0.0
    sel = raw.gather(-1, top_idx[..., None, :].expand(*lead, raw.shape[-2],
                                                      k))         # [.., 56, k]
    cx, cy, w, h = sel[..., 0, :], sel[..., 1, :], sel[..., 2, :], \
        sel[..., 3, :]
    boxes = torch.stack([cx - w * 0.5, cy - h * 0.5,
                         cx + w * 0.5, cy + h * 0.5], dim=-1)     # [.., k, 4]
    poses = sel[..., 5:5 + C.NUM_KEYPOINTS * 3, :].transpose(-1, -2) \
        .reshape(*lead, k, C.NUM_KEYPOINTS, 3)
    z = valid[..., None]
    return Detections(
        poses=torch.where(z[..., None], poses, 0.0),
        boxes=torch.where(z, boxes, 0.0),
        scores=torch.where(valid, sel[..., 4, :], 0.0),
        valid=valid,
    )


def decode_yolo_output_batch(raw: torch.Tensor, conf_threshold: float,
                             max_candidates: int = 256) -> Detections:
    """The batched decode [B, 56, A] -> Detections with a leading batch
    axis (reference: detectBatch, yolo_pose_engine.cpp:648-703)."""
    if raw.dim() != 3:
        raise ValueError(f"decode_yolo_output_batch: [B, 56, A], got "
                         f"{tuple(raw.shape)}")
    return decode_yolo_output(raw, conf_threshold, max_candidates)
