"""The per-frame pipeline: letterbox -> YOLO-pose -> decode -> pose-NMS ->
tracker step -> outputs, after posebyte_tpu/pipeline/runner.py:149-194
(the step), :340 (process_frame) and :417 (fetch_outputs).

Everything from the frame's bytes to the per-detection track outputs runs
on the pipeline's device; the host copies one frame in and, in
fetch_outputs, the small output tensors out. PyTorch runs eagerly, so the
step is a plain method.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from ..core.config import PipelineConfig
from ..core.device import resolve_device, set_numeric_settings
from ..core.structs import TrackerState
from ..models.weights import fold_stem_preprocess
from ..models.yolo_pose import MODEL_CONFIGS, forward_heads
from ..ops.decode import decode_topk
from ..ops.nms import pose_nms
from ..ops.preprocess import letterbox_flat_nhwc, letterbox_params
from ..tracker.output import TrackOutput, extract_outputs_device
from ..tracker.step import tracker_step

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


class PosePipeline:
    """End-to-end pose tracking on one device.

    params: the unfolded checkpoint in the port's layout
    (models.load_params / models.params_from_jax). device: None runs on the
    CUDA card and raises when there is none; "cpu" runs the plain versions
    of the kernels. Constructing it sets the process-wide numeric settings
    (core.set_numeric_settings: TF32 off, cuDNN autotuning off)."""

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 params: dict | None = None, device=None):
        det_cfg, trk_cfg = config.detector, config.tracker
        if params is None:
            raise ValueError("params are required (models.load_params)")
        if config.precision not in _DTYPES:
            raise NotImplementedError(
                f"precision {config.precision!r} is not ported")
        if not det_cfg.raw_preproc or det_cfg.decode_fusion != "post":
            raise NotImplementedError("the port runs raw_preproc=True with "
                                      "decode_fusion='post'")
        self.config = config
        self.device = resolve_device(device)
        set_numeric_settings()
        self.dtype = _DTYPES[config.precision]
        self.family = MODEL_CONFIGS[config.model_name].family
        self.params = self._device_params(fold_stem_preprocess(params))
        self.state = TrackerState.init(trk_cfg.max_tracks,
                                       trk_cfg.max_detections, self.device)
        self.timing = {"dispatch_ms": 0.0, "frames": 0}

    def _device_params(self, params: dict) -> dict:
        out = {}
        for k, v in params.items():
            t = torch.as_tensor(np.asarray(v, np.float32)).to(
                self.device, self.dtype)
            if t.dim() == 4:
                t = t.contiguous(memory_format=torch.channels_last)
            out[k] = t
        return out

    def _step(self, frame_flat: torch.Tensor, h: int, w: int):
        """One frame on the device. The stages carry profiler labels
        (utils/profiling.py reads them); a label costs a few microseconds
        of host time when no profiler is active."""
        det_cfg, trk_cfg = self.config.detector, self.config.tracker
        with record_function("letterbox"):
            img = letterbox_flat_nhwc(frame_flat, w, h, det_cfg.input_size,
                                      out_dtype=self.dtype)
        with record_function("model"):
            box, cls, kpt = forward_heads(self.params, img[None],
                                          self.family)
        with record_function("decode"):
            det = decode_topk(box[0], cls[0], kpt[0],
                              det_cfg.conf_threshold,
                              det_cfg.max_candidates, det_cfg.input_size,
                              topk_impl=det_cfg.topk_impl)
        with record_function("nms"):
            det = pose_nms(det, det_cfg.iou_threshold,
                           det_cfg.oks_threshold, det_cfg.max_detections)
        with record_function("tracker"):
            state, aux = tracker_step(self.state, det, trk_cfg)
        with record_function("outputs"):
            ids, scores, poses, boxes, emit = extract_outputs_device(
                state, det.scores, trk_cfg)
        out = {"ids": ids, "scores": scores, "poses": poses, "boxes": boxes,
               "emit": emit, "num_active": aux["num_active"],
               "det_scores": det.scores, "det_valid": det.valid}
        return state, out

    def process_frame(self, frame_bgr: np.ndarray, block: bool = False):
        """Run one frame (uint8 HWC BGR); returns the output tensors on the
        device. Asynchronous on the card unless block=True."""
        h, w = frame_bgr.shape[:2]
        t0 = time.perf_counter()
        flat = torch.from_numpy(
            np.ascontiguousarray(frame_bgr, dtype=np.uint8).reshape(-1))
        with torch.inference_mode():
            self.state, out = self._step(flat.to(self.device), h, w)
        if block and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timing["dispatch_ms"] += (time.perf_counter() - t0) * 1e3
        self.timing["frames"] += 1
        return out

    def fetch_outputs(self, out, frame_w: int, frame_h: int):
        """The one device-to-host copy: outputs -> list of TrackOutput in
        frame coordinates (reference: getActiveTracks + scaleTrackOutputs,
        main.cpp:48-68, 224)."""
        ids, scores, poses, boxes, emit = (
            out[k].cpu().numpy()
            for k in ("ids", "scores", "poses", "boxes", "emit"))
        scale, _, _, pad_x, pad_y = letterbox_params(
            frame_w, frame_h, self.config.detector.input_size)
        pad = np.asarray([pad_x, pad_y], np.float32)
        results = []
        for d in range(len(ids)):
            if not emit[d]:
                continue
            kp = poses[d].copy()
            kp[:, :2] = (kp[:, :2] - pad) / scale
            bb = boxes[d].copy()
            bb[0:2] = (bb[0:2] - pad) / scale
            bb[2:4] = (bb[2:4] - pad) / scale
            results.append(TrackOutput(track_id=int(ids[d]),
                                       score=float(scores[d]),
                                       bbox=bb, keypoints=kp))
        return results

    def reset(self):
        trk_cfg = self.config.tracker
        self.state = TrackerState.init(trk_cfg.max_tracks,
                                       trk_cfg.max_detections, self.device)
