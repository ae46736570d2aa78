"""Filter models of the port: the face detector and the part chain (nose,
mouth, eyes)."""

from .eye import EyeDetector, EyeDetectorConfig
from .face import FaceDetector, FaceDetectorConfig
from .mouth import MouthDetector, MouthDetectorConfig
from .nose import NoseDetector, NoseDetectorConfig

__all__ = ["EyeDetector", "EyeDetectorConfig", "FaceDetector",
           "FaceDetectorConfig", "MouthDetector", "MouthDetectorConfig",
           "NoseDetector", "NoseDetectorConfig"]
