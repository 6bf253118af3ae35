"""Tracker-state checkpoint and resume (posebyte_tpu/utils/checkpoint.py):
a TrackerState, and a KalmanState136, to and from safetensors files in the
JAX package's layout and metadata, so that either package loads a file the
other wrote and a long video job can stop and resume with the same track
identities. numpy only (models/weights.py reads and writes the format);
loaded tensors lie on `device`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.structs import KalmanState136, TrackerState
from ..models.weights import read_safetensors, write_safetensors
from ..ops.reid import REID_DIM

TRACKER_FORMAT = "posebyte-tracker-v1"
KALMAN_FORMAT = "posebyte-kalman136-v1"


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_tracker_state(state: TrackerState, path: str):
    write_safetensors(path, {f.name: _numpy(getattr(state, f.name))
                             for f in dataclasses.fields(state)},
                      metadata={"format": TRACKER_FORMAT})


def load_tracker_state(path: str, device="cpu") -> TrackerState:
    """A saved TrackerState; a file without `embeddings` (written before
    Re-ID) gets them at their initial value, zeros [T, 51]."""
    arrays, _ = read_safetensors(path)
    if "embeddings" not in arrays:
        arrays["embeddings"] = np.zeros((arrays["poses"].shape[0], REID_DIM),
                                        np.float32)
    return TrackerState(**{k: torch.from_numpy(v).to(device)
                           for k, v in arrays.items()})


def save_kalman_state(state: KalmanState136, path: str):
    write_safetensors(path, {"mean": _numpy(state.mean),
                             "cov_diag": _numpy(state.cov_diag)},
                      metadata={"format": KALMAN_FORMAT})


def load_kalman_state(path: str, device="cpu") -> KalmanState136:
    arrays, _ = read_safetensors(path)
    return KalmanState136(mean=torch.from_numpy(arrays["mean"]).to(device),
                          cov_diag=torch.from_numpy(arrays["cov_diag"])
                          .to(device))
