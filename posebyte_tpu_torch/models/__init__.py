"""The YOLO-pose families (v8 and v11), their random initialisation,
their checkpoints (the JAX package's safetensors and Ultralytics .pt
files), the learned Re-ID head, training (models.train), the detection
engine (models.engine.YoloPoseEngine, loaded on first touch) and its
locked export (models.aot)."""
from .reid_head import (apply_reid_head, init_reid_head, load_reid_head,
                        reid_head_from_jax, save_reid_head)
from .weights import (convert_state_dict, fold_stem_preprocess,
                      load_params, load_pretrained,
                      load_ultralytics_checkpoint, params_from_jax,
                      read_safetensors, save_params)
from .yolo_pose import (MODEL_CONFIGS, ModelConfig, build_model,
                        build_model_heads, forward_heads, forward_raw,
                        init_params, make_anchors)


def __getattr__(name):
    # The engine pulls in the legacy NMS and the dense decode: loaded on
    # first touch, as in the JAX package.
    if name == "YoloPoseEngine":
        from .engine import YoloPoseEngine
        return YoloPoseEngine
    raise AttributeError(name)


__all__ = ["MODEL_CONFIGS", "ModelConfig", "build_model",
           "build_model_heads", "forward_raw", "YoloPoseEngine",
           "forward_heads", "make_anchors",
           "init_params", "init_reid_head", "save_reid_head",
           "load_params", "params_from_jax", "read_safetensors",
           "save_params", "load_pretrained", "load_ultralytics_checkpoint",
           "convert_state_dict",
           "fold_stem_preprocess", "apply_reid_head", "load_reid_head",
           "reid_head_from_jax"]
