"""Core data model: constants, configs, tensor structs, device choice."""
from . import constants
from .config import (DetectorConfig, LegacyTrackerConfig, PipelineConfig,
                     TrackerConfig)
from .device import resolve_device, set_numeric_settings
from .structs import Detections, KalmanState136, TrackerState

__all__ = ["constants", "TrackerConfig", "DetectorConfig", "PipelineConfig",
           "LegacyTrackerConfig",
           "Detections", "KalmanState136", "TrackerState", "resolve_device",
           "set_numeric_settings"]
