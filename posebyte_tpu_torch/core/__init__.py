"""Core data model: constants, configs, tensor structs, device choice."""
from . import constants
from .config import DetectorConfig, PipelineConfig, TrackerConfig
from .device import resolve_device, set_numeric_settings
from .structs import Detections, TrackerState

__all__ = ["constants", "TrackerConfig", "DetectorConfig", "PipelineConfig",
           "Detections", "TrackerState", "resolve_device",
           "set_numeric_settings"]
