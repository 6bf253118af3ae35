"""The system under test: the PyTorch port's PosePipeline, built as a
configuration file states it. The port is imported only inside these
functions, so that importing the harness needs nothing of it."""
from __future__ import annotations

import os

from ..reference.scene import calibration_frames
from .spec import ROOT


def pipeline_config(config: dict):
    from posebyte_tpu_torch.core.config import (DetectorConfig,
                                                PipelineConfig,
                                                TrackerConfig)
    return PipelineConfig(
        detector=DetectorConfig(input_size=config["input_size"],
                                **config["detector"]),
        tracker=TrackerConfig(**config["tracker"]),
        model_name=config["model"], precision=config["precision"])


def build(config: dict, seed: int, device, root: str = ROOT):
    """A PosePipeline on `device` ("cuda" or, in tests, "cpu") with the
    configuration's checkpoint; at int8 the program quantises it and
    calibrates its activation scales on the configuration's calibration
    frames, drawn from `seed`."""
    from posebyte_tpu_torch.models.weights import load_params
    from posebyte_tpu_torch.pipeline.runner import PosePipeline
    params, _ = load_params(os.path.join(root, config["checkpoint"]),
                            config["model"])
    if config["precision"] == "int8":
        from posebyte_tpu_torch.models import quant
        q = config["quant"]
        if tuple(q["skip"]) != tuple(quant.PARTIAL_QUANT_SKIP):
            raise SystemExit(f"the configuration keeps {q['skip']} float, "
                             f"the program {quant.PARTIAL_QUANT_SKIP}")
        frames = calibration_frames(q["calibration_frames"],
                                    config["input_size"],
                                    q["calibration_persons"], seed)
        params = quant.calibrate_activations(
            quant.quantize_params(params), config["model"], frames,
            method=q["calibration"], device=device)
    return PosePipeline(pipeline_config(config), params, device=device)


def tracker_state_numpy(state) -> dict:
    """The program's tracker state (a TrackerState on its device) as the
    reference tracker's numpy state: the program's own state, from which
    the reference follows a chunk taken from the middle of a window."""
    return {"poses": state.poses.cpu().numpy().copy(),
            "velocities": state.velocities.cpu().numpy().copy(),
            "ids": state.ids.cpu().numpy().astype("int64"),
            "states": state.states.cpu().numpy().astype("int64"),
            "hits": state.hits.cpu().numpy().astype("int64"),
            "ages": state.ages.cpu().numpy().astype("int64"),
            "active": state.active.cpu().numpy().copy(),
            "next_id": int(state.next_id.cpu())}
