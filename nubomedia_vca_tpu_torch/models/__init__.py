"""Filter models of the port: the face detector, the part chain (nose,
mouth, eyes) and the learned face detector (bf16 and int8)."""

from .cnn import CnnFaceDetector
from .eye import EyeDetector, EyeDetectorConfig
from .face import FaceDetector, FaceDetectorConfig
from .mouth import MouthDetector, MouthDetectorConfig
from .nose import NoseDetector, NoseDetectorConfig
from .quant import QuantizedCnnFaceDetector

__all__ = ["CnnFaceDetector", "EyeDetector", "EyeDetectorConfig",
           "FaceDetector", "FaceDetectorConfig", "MouthDetector",
           "MouthDetectorConfig", "NoseDetector", "NoseDetectorConfig",
           "QuantizedCnnFaceDetector"]
