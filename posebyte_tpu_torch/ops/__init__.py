"""Compute primitives on torch tensors; Kernel 1 (pose-NMS keep mask),
Kernel 2 (auction) and Kernel 3 (the tracker over a chunk) are
hand-written CUDA behind ops.nms, ops.assignment and ops.tracker_chunk
(whose dispatcher shares the module's name, so it is not re-exported
here)."""
from .assignment import (auction, auction_assign, auction_assign_cuda,
                         auction_iterations, filter_matches_by_threshold,
                         greedy_assign)
from .decode import (decode_topk, decode_topk_levels, decode_yolo_output,
                     decode_yolo_output_batch)
from .gating import spatial_gate
from .geometry import (boxes_iou_matrix, centers_iou_matrix,
                       masked_pose_bbox, pose_area, pose_centers)
from .kalman import Kalman136, cv_predict, cv_update
from .legacy_nms import legacy_oks_pair_matrix, legacy_pose_nms
from .nms import (nms_keep, nms_keep_cuda, nms_keep_plain,
                  nms_overlap_matrix, pose_nms)
from .oks import (combine_costs, oks_distance_matrix, oks_matrix,
                  torso_oks_matrix)
from .preprocess import (letterbox_flat, letterbox_flat_nhwc,
                         letterbox_image, letterbox_params,
                         unletterbox_coords)
from .reid import (REID_DIM, blend_reid_cost, cosine_cost_matrix,
                   ema_update, make_embed_fn, pose_color_embedding)
from .tracker_chunk import tracker_chunk_cuda, tracker_chunk_plain

__all__ = [
    "auction", "auction_assign", "auction_assign_cuda", "auction_iterations",
    "filter_matches_by_threshold", "greedy_assign", "decode_topk",
    "decode_topk_levels", "decode_yolo_output", "decode_yolo_output_batch",
    "legacy_pose_nms", "legacy_oks_pair_matrix",
    "spatial_gate", "boxes_iou_matrix", "centers_iou_matrix",
    "masked_pose_bbox", "pose_area", "pose_centers", "Kalman136",
    "cv_predict", "cv_update", "nms_keep", "nms_keep_cuda",
    "nms_keep_plain", "nms_overlap_matrix", "pose_nms", "combine_costs",
    "oks_distance_matrix", "oks_matrix", "torso_oks_matrix",
    "letterbox_flat", "letterbox_flat_nhwc", "letterbox_image",
    "letterbox_params", "unletterbox_coords", "REID_DIM", "blend_reid_cost",
    "cosine_cost_matrix", "ema_update", "make_embed_fn",
    "pose_color_embedding", "tracker_chunk_cuda", "tracker_chunk_plain",
]
