"""Compute primitives on torch tensors; Kernel 1 (pose-NMS keep mask) and
Kernel 2 (auction) are hand-written CUDA behind ops.nms and
ops.assignment."""
from .assignment import (auction_assign, auction_assign_cuda,
                         auction_iterations)
from .decode import decode_topk
from .gating import spatial_gate
from .geometry import (boxes_iou_matrix, centers_iou_matrix,
                       masked_pose_bbox, pose_centers)
from .kalman import cv_predict, cv_update
from .nms import (nms_keep, nms_keep_cuda, nms_keep_plain,
                  nms_overlap_matrix, pose_nms)
from .oks import oks_matrix, torso_oks_matrix
from .preprocess import (letterbox_flat_nhwc, letterbox_params,
                         unletterbox_coords)

__all__ = [
    "auction_assign", "auction_assign_cuda", "auction_iterations",
    "decode_topk", "spatial_gate", "boxes_iou_matrix", "centers_iou_matrix",
    "masked_pose_bbox", "pose_centers", "cv_predict", "cv_update",
    "nms_keep", "nms_keep_cuda", "nms_keep_plain", "nms_overlap_matrix",
    "pose_nms", "oks_matrix", "torso_oks_matrix", "letterbox_flat_nhwc",
    "letterbox_params", "unletterbox_coords",
]
