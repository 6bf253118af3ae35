"""YOLO-pose model family (v8 ported; v11 waits for a later slice) and the
learned Re-ID head."""
from .reid_head import apply_reid_head, load_reid_head, reid_head_from_jax
from .weights import (fold_stem_preprocess, load_params, params_from_jax,
                      read_safetensors, save_params)
from .yolo_pose import MODEL_CONFIGS, ModelConfig, forward_heads, make_anchors

__all__ = ["MODEL_CONFIGS", "ModelConfig", "forward_heads", "make_anchors",
           "load_params", "params_from_jax", "read_safetensors",
           "save_params",
           "fold_stem_preprocess", "apply_reid_head", "load_reid_head",
           "reid_head_from_jax"]
