"""YoloPoseEngine, the detection-engine facade, after
posebyte_tpu/models/engine.py (reference: the TensorRT wrapper,
include/tensorrt/yolo_pose_engine.h:59-130,
src/tensorrt/yolo_pose_engine.cpp):

  build_from_checkpoint  <- buildFromONNX (weights import; int8 through
                            models.quant.calibrate_and_quantize)
  save_engine/load_engine <- saveEngine/loadEngine (safetensors)
  detect                 <- detect() (host numpy in, host lists out, the
                            legacy NMS rules of ops/legacy_nms.py)
  detect_batch           <- detectBatch() (one batched forward)
  detect_from_device     <- detectFromDevice() (device frame in, host
                            list out)
  detect_device_native   <- detectGPUNative() (device frame in, device
                            Detections out; pose_nms, Kernel 1 on the card)

Every path runs the normalised letterbox (raw_preproc is forced off, as in
the JAX engine: the engine's params stay in the checkpoint's unfolded form)
and the dense decode (forward_raw, decode_yolo_output). The engine runs on
the CUDA card unless given device="cpu". Its params are the checkpoint's
flat dict; assigning engine.params prepares them for the device again
(models.layers.prepare_params), so the next call serves them: w8a8 params
(calibrated int8) run every quantised conv through Kernel 4 on the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.config import DetectorConfig
from ..core.device import resolve_device, set_numeric_settings
from ..core.structs import Detections
from ..ops.decode import decode_yolo_output, decode_yolo_output_batch
from ..ops.legacy_nms import legacy_pose_nms
from ..ops.nms import pose_nms
from ..ops.preprocess import letterbox_flat_nhwc, letterbox_params
from .layers import prepare_params
from .yolo_pose import MODEL_CONFIGS, build_model


class YoloPoseEngine:
    """Pose detection engine over the YOLO-pose forward (forward_raw).

    precision "fp32" computes in float32, "bf16" and "int8" in bfloat16
    (int8 params run their w8a8 convs through Kernel 4). params None draws
    the model's random weights from `seed` (init_params). Constructing it
    sets the process-wide numeric settings (core.set_numeric_settings)."""

    def __init__(self, model_name: str = "yolov8n-pose",
                 config: DetectorConfig = DetectorConfig(),
                 params: dict | None = None, precision: str = "bf16",
                 seed: int = 0, device=None):
        if model_name not in MODEL_CONFIGS:
            raise ValueError(f"unknown model {model_name}")
        self.model_name = model_name
        if config.raw_preproc:
            config = dataclasses.replace(config, raw_preproc=False)
        self.config = config
        self.precision = precision
        self.device = resolve_device(device)
        set_numeric_settings()
        self.dtype = torch.float32 if precision == "fp32" else torch.bfloat16
        self.apply_fn, init_fn = build_model(model_name, self.dtype)
        self.params = params if params is not None else init_fn(seed)
        self.last_inference_ms = 0.0

    @property
    def params(self) -> dict:
        """The checkpoint's flat dict the engine serves."""
        return self._params

    @params.setter
    def params(self, value: dict):
        self._params = value
        self._prepared = prepare_params(value, self.dtype, self.device)

    # -- engine build / serialise (reference: 183-495) ---------------------
    @classmethod
    def build_from_checkpoint(cls, path: str, model_name: str,
                              precision: str = "bf16", calib_dir: str = "",
                              config: DetectorConfig = DetectorConfig(),
                              device=None):
        """buildFromONNX's counterpart: import the weights (.pt or
        .safetensors) and apply the precision policy (int8: the partial
        quantisation, the stem kept in float, calibrated on the images in
        calib_dir, on the engine's device)."""
        from .weights import load_pretrained
        params = load_pretrained(path, model_name)
        if precision == "int8":
            from .quant import calibrate_and_quantize
            params = calibrate_and_quantize(
                params, model_name, calib_dir, config.input_size,
                device=resolve_device(device))
        return cls(model_name, config, params=params, precision=precision,
                   device=device)

    def save_engine(self, path: str):
        from .weights import save_params
        save_params(self.params, path, self.model_name)

    @classmethod
    def load_engine(cls, path: str, precision: str = "bf16",
                    config: DetectorConfig = DetectorConfig(), device=None):
        from .weights import load_params
        params, name = load_params(path)
        return cls(name, config, params=params, precision=precision,
                   device=device)

    # -- the device-native path (reference: detectGPUNative, 610-646) -------
    def _native(self, frame_flat_u8: torch.Tensor, height: int,
                width: int) -> Detections:
        cfg = self.config
        with torch.inference_mode():
            img = letterbox_flat_nhwc(frame_flat_u8.to(self.device), width,
                                      height, cfg.input_size)
            raw = self.apply_fn(self._prepared, img[None])
            det = decode_yolo_output(raw[0], cfg.conf_threshold,
                                     cfg.max_candidates)
            return pose_nms(det, cfg.iou_threshold, cfg.oks_threshold,
                            cfg.max_detections)

    def detect_device_native(self, frame_flat_u8: torch.Tensor, height: int,
                             width: int) -> Detections:
        """A flat u8 frame [H*W*3] on the device -> Detections on the
        device (chains into the tracker with no host crossing). The
        letterbox is the per-frame matmul lowering; last_inference_ms is the
        host's time to issue the work, as in the JAX engine."""
        t0 = time.perf_counter()
        out = self._native(frame_flat_u8, height, width)
        self.last_inference_ms = (time.perf_counter() - t0) * 1e3
        return out

    # -- the legacy host paths (reference: detect/detectBatch, 559-703) ----
    def detect(self, image_bgr: np.ndarray,
               conf_threshold: Optional[float] = None,
               nms_threshold: Optional[float] = None):
        """One uint8 HWC BGR image -> list of {"bbox", "score",
        "keypoints"} in image coordinates, through the legacy NMS rules
        (the reference's detect() -> postprocess() -> NMSCuda::apply)."""
        return self.detect_batch(image_bgr[None], conf_threshold,
                                 nms_threshold)[0]

    def detect_batch(self, images_bgr: np.ndarray,
                     conf_threshold: Optional[float] = None,
                     nms_threshold: Optional[float] = None):
        """[B, H, W, 3] uint8 BGR -> a list per image of detect's lists.
        nms_threshold is accepted and unused, as in the JAX engine (the
        legacy rules hardcode theirs). last_inference_ms covers the copy
        in, the forward, decode, NMS and the copy out."""
        cfg = self.config
        conf = cfg.conf_threshold if conf_threshold is None \
            else conf_threshold
        B, H, W = images_bgr.shape[:3]
        flat = torch.from_numpy(np.ascontiguousarray(images_bgr,
                                                     np.uint8).reshape(B, -1))
        t0 = time.perf_counter()
        with torch.inference_mode():
            imgs = letterbox_flat_nhwc(flat.to(self.device), W, H,
                                       cfg.input_size, selection=True)
            raw = self.apply_fn(self._prepared, imgs)
            dets = decode_yolo_output_batch(raw, conf, cfg.max_candidates)
            kept = [legacy_pose_nms(Detections(dets.poses[b], dets.boxes[b],
                                               dets.scores[b], dets.valid[b]),
                                    max_keep=cfg.max_detections)
                    for b in range(B)]
            boxes, poses, scores, valid = (
                torch.stack([getattr(d, f) for d in kept]).cpu().numpy()
                for f in ("boxes", "poses", "scores", "valid"))
        self.last_inference_ms = (time.perf_counter() - t0) * 1e3

        scale, _, _, pad_x, pad_y = letterbox_params(W, H, cfg.input_size)
        pad2 = np.asarray([pad_x, pad_y], np.float32)
        pad4 = np.asarray([pad_x, pad_y, pad_x, pad_y], np.float32)
        results = []
        for b in range(B):
            img_dets = []
            for d in range(boxes.shape[1]):
                if not valid[b, d]:
                    continue
                kp = poses[b, d].copy()
                kp[:, :2] = (kp[:, :2] - pad2) / scale
                img_dets.append({"bbox": (boxes[b, d] - pad4) / scale,
                                 "score": float(scores[b, d]),
                                 "keypoints": kp})
            results.append(img_dets)
        return results

    def detect_from_device(self, frame_flat_u8: torch.Tensor, height: int,
                           width: int):
        """A device frame in, a host list of {"bbox", "score", "keypoints"}
        in letterbox coordinates out (reference: detectFromDevice,
        yolo_pose_engine.cpp:582-608)."""
        det = self.detect_device_native(frame_flat_u8, height, width)
        boxes, poses, scores, valid = (
            getattr(det, f).cpu().numpy()
            for f in ("boxes", "poses", "scores", "valid"))
        return [{"bbox": boxes[d], "score": float(scores[d]),
                 "keypoints": poses[d]}
                for d in range(len(scores)) if valid[d]]

    def get_last_inference_time(self) -> float:
        """Milliseconds of the last detect call (reference:
        getLastInferenceTime)."""
        return self.last_inference_ms
