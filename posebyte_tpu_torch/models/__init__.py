"""YOLO-pose model family (v8 ported; v11 waits for a later slice)."""
from .weights import (fold_stem_preprocess, load_params, params_from_jax,
                      read_safetensors)
from .yolo_pose import MODEL_CONFIGS, ModelConfig, forward_heads, make_anchors

__all__ = ["MODEL_CONFIGS", "ModelConfig", "forward_heads", "make_anchors",
           "load_params", "params_from_jax", "read_safetensors",
           "fold_stem_preprocess"]
