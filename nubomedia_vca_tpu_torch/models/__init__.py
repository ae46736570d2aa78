"""Filter models of the port: the face detector, the part chain (nose,
mouth, eyes, ear), the motion tracker and the learned face detector (bf16
and int8)."""

from .cnn import CnnFaceDetector
from .ear import EarDetector, EarDetectorConfig
from .eye import EyeDetector, EyeDetectorConfig
from .face import FaceDetector, FaceDetectorConfig
from .mouth import MouthDetector, MouthDetectorConfig
from .nose import NoseDetector, NoseDetectorConfig
from .quant import QuantizedCnnFaceDetector
from .tracker import Tracker, TrackerConfig

__all__ = ["CnnFaceDetector", "EarDetector", "EarDetectorConfig",
           "EyeDetector", "EyeDetectorConfig", "FaceDetector",
           "FaceDetectorConfig", "MouthDetector", "MouthDetectorConfig",
           "NoseDetector", "NoseDetectorConfig", "QuantizedCnnFaceDetector",
           "Tracker", "TrackerConfig"]
