"""Remote-object API surface — the Kurento-compatible layer (L2/L3 rebuild).

Each class mirrors its kmd.json remote class 1:1 — same class name, same
method names and parameters (e.g. nubofacedetector.NuboFaceDetector.kmd.json:
2-234; generated Impl setters NuboFaceDetectorImpl.cpp:158-237) — mapped
onto the port's filter models instead of g_object_set on a GStreamer
element.

Events: subscribing to "OnFace"/"OnEye"/... delivers payloads with the
reference's complex types (FaceInfo{name,x,y,width,height} lists) built from
the same wire string the reference emits, rate-limited by events-ms.

The PyTorch port of ``nubomedia_vca_tpu/api/objects.py``, with the same
classes, public methods, parameter names, annotations and order, so the
kmd.json IDL that ``api/idl.py`` reads from them is the JAX package's. A
``MediaPipeline`` carries the device its elements' models run on (the card
unless the caller asks for another; a CUDA request on a host without CUDA
raises); every helper added here is private, because ``idl.describe``
lists each public function of the filter classes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cascade.engine import _resolve_device
from ..models.face import FaceDetector, FaceDetectorConfig
from ..models.eye import EyeDetector, EyeDetectorConfig
from ..models.mouth import MouthDetector, MouthDetectorConfig
from ..models.nose import NoseDetector, NoseDetectorConfig
from ..models.ear import EarDetector, EarDetectorConfig
from ..models.tracker import Tracker, TrackerConfig
from ..pipeline.events import EventRateLimiter, to_wire_string, Detection


@dataclasses.dataclass
class Info:
    """The kmd complex type {name, x, y, width, height} (FaceInfo/EyeInfo/
    MouthInfo/NoseInfo/EarInfo/TrackerInfo)."""

    name: str
    x: int
    y: int
    width: int
    height: int


class MediaPipeline:
    """Lifecycle container (the reference's MediaPipelineImpl analog):
    elements are created in a pipeline and fed frame batches by the host
    ingest (the WebRTC/RTP decode path lives outside this framework).
    `device` is where its elements' models run and its frames are drawn."""

    def __init__(self, frame_size=(640, 480),
                 device: str | torch.device = "cuda"):
        self.frame_size = frame_size
        self.device = _resolve_device(device)
        self.elements = []
        self._runner = None

    def register(self, el):
        self.elements.append(el)
        return el

    # --- media loop (RPC-invokable) ----------------------------------------
    def listen(self, port: int = 0, channels: int = 1, output: int = 0,
               downscale: int = 0) -> int:
        """Start the media loop and open its raw-video TCP port (the
        WebRTC/RTP-decode stand-in; see api/media_loop.py). Returns the
        bound port; push W*H(*channels) bytes per frame per connection.

        output=1: annotated frames are written back on each stream's
        connection (the reference's annotated-stream product; BGR for
        channels 3/4, GRAY8 otherwise).
        downscale=1: frames are downscaled to the elements' working
        resolution at ingest (H2D traffic cut ~(W/work_w)^2×; requires all
        elements to share one working resolution). Combined
        output=1+downscale=1 needs a color listener: detection runs on the
        work-res luma, annotations are drawn host-side on the retained
        full-res BGR frame (kmsfacedetect.cpp:805,832-850)."""
        from .media_loop import MediaRunner
        if self._runner is None:
            self._runner = MediaRunner(self)
        return self._runner.listen(int(port), int(channels),
                                   output=bool(int(output)),
                                   downscale=bool(int(downscale)))

    def pushFrame(self, frame, pts: int = 0, stream: int = 0):
        """In-process frame feed into the media loop (tests / co-located
        apps); starts the loop on first use."""
        from .media_loop import MediaRunner
        if self._runner is None:
            self._runner = MediaRunner(self)
        self._runner.push(np.asarray(frame, dtype=np.uint8), pts, stream)

    def framesProcessed(self) -> int:
        return self._runner.frames_processed if self._runner else 0

    def getStats(self) -> dict:
        """RPC-invokable serving counters (media_loop.MediaRunner.stats)."""
        return self._runner.stats() if self._runner else {}

    def stopMedia(self):
        if self._runner is not None:
            self._runner.stop()
            self._runner = None

    def release(self):
        self.stopMedia()
        self.elements.clear()


class _FilterObject:
    """Shared method surface (every kmd module repeats these)."""

    EVENT_NAME = "OnFace"
    INFO_NAME = "face"

    def __init__(self, mediaPipeline: MediaPipeline):
        import threading

        self.pipeline = mediaPipeline
        self._listeners = {}
        self._rate = EventRateLimiter(30001)
        self._dirty = True
        self._model = None
        # the reference guards property access + processing with a
        # per-element GRecMutex (kmsfacedetect.cpp:44-48,873-885): RPC
        # setter threads and the media-loop thread contend here too
        self._lock = threading.RLock()
        mediaPipeline.register(self)

    # --- knob plumbing ----------------------------------------------------
    def _set(self, **kw):
        for k, v in kw.items():
            setattr(self._config, k, v)
        self._dirty = True

    def _ensure_model(self):
        """Build on first use; afterwards apply config deltas to the LIVE
        model via its reconfigure() — mid-stream RPC setters preserve track
        IDs / temporal merges / MHI state, matching the reference's
        g_object_set on a running element (kmsfacedetect.cpp:504-582)."""
        with self._lock:
            if self._model is None:
                self._model = self._build_model()
                self._dirty = False
            elif self._dirty:
                self._reconfigure_model()
                self._dirty = False
            return self._model

    def _reconfigure_model(self):
        self._model.reconfigure(self._config)

    # --- kmd methods common to all detector modules -----------------------
    def detectByEvent(self, event: int):
        self._set(detect_event=int(event))

    def sendMetaData(self, metaData: int):
        self._set(send_meta_data=int(metaData))

    def multiScaleFactor(self, scaleFactor: int):
        self._set(multi_scale_factor=int(scaleFactor))

    def processXevery4Frames(self, xper4: int):
        self._set(process_x_every_4_frames=int(xper4))

    def widthToProcess(self, width: int):
        self._set(width_to_process=int(width))

    def activateServerEvents(self, activate: int, time: int):
        self._set(activate_events=int(activate), events_ms=int(time))
        self._rate = EventRateLimiter(int(time))

    def setOverlayedImage(self, uri: str, offsetXPercent: float,
                          offsetYPercent: float, widthPercent: float,
                          heightPercent: float):
        self._overlay = (uri, offsetXPercent, offsetYPercent,
                         widthPercent, heightPercent)

    def unsetOverlayedImage(self):
        self._overlay = None

    # --- events -----------------------------------------------------------
    def addEventListener(self, event: str, callback):
        self._listeners.setdefault(event, []).append(callback)

    def _emit(self, rects_with_names):
        if not self._config.activate_events or not rects_with_names:
            return
        if not self._rate.ready():
            return
        infos = [Info(n, *r[:4]) for (n, r) in rects_with_names]
        wire = to_wire_string(
            [Detection(n, *r[:4]) for (n, r) in rects_with_names])
        for cb in self._listeners.get(self.EVENT_NAME, []):
            cb({"type": self.EVENT_NAME,
                f"{self.INFO_NAME}Info": infos, "wire": wire})

    # --- frame feeding ----------------------------------------------------
    def process(self, frames):
        raise NotImplementedError

    # --- rendering (view toggle + setOverlayedImage) ----------------------
    @staticmethod
    def _result_rects(result) -> list:
        if isinstance(result, dict):
            return [r for rects in result.values() for r in rects]
        if isinstance(result, list):
            return [f.rect() if hasattr(f, "rect") else tuple(f)
                    for f in result]
        return []

    def _view_enabled(self) -> bool:
        return bool(getattr(self._config, "view", 1))

    def render(self, frames, results, fetch=None, host=False):
        """Draw detections (and the costume overlay, when set) onto frames —
        the reference's in-place view path, as a pure device op. host=True
        uses the bit-identical numpy twins instead (the serving loop's
        detect-downscaled mode draws on the retained full-res frame
        host-side, like the reference's CPU draw on img_orig,
        kmsfacedetect.cpp:832-850)."""
        from .render import render_detections, load_overlay_image
        if not self._view_enabled():
            return frames
        overlay = None
        if getattr(self, "_overlay", None) is not None:
            uri, ox, oy, wp, hp = self._overlay
            overlay = (load_overlay_image(uri, fetch=fetch), (ox, oy, wp, hp))
        rects = [self._result_rects(r) for r in results]
        kw = {}
        if getattr(frames, "ndim", None) == 4:
            # color frames: the reference draws BaseFace::colors[1] =
            # CV_RGB(0,128,255) (BGR 255,128,0) on every rect
            # (BaseFace.cpp:70-82, kmsfacedetect.cpp:144-151)
            kw["color"] = self.RENDER_COLOR
        return render_detections(frames, rects, mode=self.RENDER_MODE,
                                 overlay=overlay, host=host,
                                 device=self.pipeline.device, **kw)

    RENDER_MODE = "rect"
    RENDER_COLOR = (255, 128, 0)


class NuboFaceDetector(_FilterObject):
    EVENT_NAME = "OnFace"
    INFO_NAME = "face"

    def __init__(self, mediaPipeline):
        self._config = FaceDetectorConfig()
        self._overlay = None
        super().__init__(mediaPipeline)

    def _build_model(self):
        return FaceDetector(self.pipeline.frame_size, self._config,
                            device=self.pipeline.device)

    # face-only kmd methods
    def showFaces(self, viewFaces: int):
        self._set(view=int(viewFaces))

    def euclideanDistance(self, distance: int):
        self._set(euclidean_distance=int(distance))

    def trackThreshold(self, threshold: int):
        self._set(track_threshold=int(threshold))

    def areaThreshold(self, threshold: int):
        self._set(area_threshold=int(threshold))

    def process(self, frames, stream: int = 0, events=None):
        with self._lock:
            model = self._ensure_model()
            res = model.process(frames, stream=stream, events=events)
        for faces in res:
            self._emit([("face", f.rect()) for f in faces])
        return res


@dataclasses.dataclass
class CnnPartDetectorConfig:
    """Knobs for the learned multi-part detector (no reference analog —
    one conv pass replaces the reference's face→eye/nose/mouth element
    chain)."""

    # None → the model's measured per-class operating points
    # (models/cnn_parts.DEFAULT_THRESHOLDS); setThreshold overrides every
    # class with one scalar, like the face CNN object's single knob
    threshold: float | None = None
    view: int = 1
    activate_events: int = 0
    events_ms: int = 30001


class NuboCnnPartDetector(_FilterObject):
    """One-pass learned face+eye+nose+mouth+profile+ear detector as a
    remote object: emits OnPart events with every part class in one
    payload (models/cnn_parts.py; trained on exact synthetic part
    geometry, scenes mirrored both ways so ears are found on either
    side without the reference's flip-and-rerun pass)."""

    EVENT_NAME = "OnPart"
    INFO_NAME = "part"

    def __init__(self, mediaPipeline):
        self._config = CnnPartDetectorConfig()
        self._overlay = None
        super().__init__(mediaPipeline)

    def _build_model(self):
        from ..models.cnn_parts import CnnPartDetector

        return CnnPartDetector(self.pipeline.frame_size,
                               threshold=self._config.threshold,
                               device=self.pipeline.device)

    def _reconfigure_model(self):
        from ..models.cnn_parts import CnnPartDetector

        if self._config.threshold != self._model.threshold:
            self._model = CnnPartDetector(
                self.pipeline.frame_size, params=self._model.params,
                threshold=self._config.threshold,
                device=self.pipeline.device)

    def setThreshold(self, threshold: float):
        self._set(threshold=float(threshold))

    def showParts(self, viewParts: int):
        self._set(view=int(viewParts))

    def process(self, frames, stream: int = 0):
        with self._lock:
            model = self._ensure_model()
            res = model.process(frames)
        for frame_res in res:
            self._emit([(k, r) for k, rects in frame_res.items()
                        for r in rects])
        return res


class _PartObject(_FilterObject):
    def process(self, frames, face_boxes=None, stream: int = 0):
        with self._lock:
            model = self._ensure_model()
            res = model.process(frames, face_boxes=face_boxes,
                                stream=stream)
        for frame_res in res:
            self._emit([(k, r) for k, rects in frame_res.items()
                        for r in rects])
        return res


class NuboEyeDetector(_PartObject):
    EVENT_NAME = "OnEye"
    INFO_NAME = "eye"
    RENDER_MODE = "circle"   # the reference draws circles for eyes

    def __init__(self, mediaPipeline):
        self._config = EyeDetectorConfig()
        self._overlay = None
        super().__init__(mediaPipeline)

    def showEyes(self, viewEyes: int):
        self._set(view=int(viewEyes))

    def _build_model(self):
        return EyeDetector(self.pipeline.frame_size, self._config,
                          device=self.pipeline.device)


class NuboMouthDetector(_PartObject):
    EVENT_NAME = "OnMouth"
    INFO_NAME = "mouth"

    def __init__(self, mediaPipeline):
        self._config = MouthDetectorConfig()
        self._overlay = None
        super().__init__(mediaPipeline)

    def showMouths(self, viewMouths: int):
        self._set(view=int(viewMouths))

    def _build_model(self):
        return MouthDetector(self.pipeline.frame_size, self._config,
                            device=self.pipeline.device)


class NuboNoseDetector(_PartObject):
    EVENT_NAME = "OnNose"
    INFO_NAME = "nose"

    def __init__(self, mediaPipeline):
        self._config = NoseDetectorConfig()
        self._overlay = None
        super().__init__(mediaPipeline)

    def showNoses(self, viewNoses: int):
        self._set(view=int(viewNoses))

    def _build_model(self):
        return NoseDetector(self.pipeline.frame_size, self._config,
                           device=self.pipeline.device)


class NuboEarDetector(_PartObject):
    EVENT_NAME = "OnEar"
    INFO_NAME = "ear"

    def __init__(self, mediaPipeline):
        self._config = EarDetectorConfig()
        self._overlay = None
        super().__init__(mediaPipeline)

    def showEars(self, viewEars: int):
        self._set(view=int(viewEars))

    def _build_model(self):
        return EarDetector(self.pipeline.frame_size, self._config,
                          device=self.pipeline.device)


class NuboTracker(_FilterObject):
    EVENT_NAME = "OnTracker"
    INFO_NAME = "tracker"

    def __init__(self, mediaPipeline):
        self._config = TrackerConfig()
        self._overlay = None
        super().__init__(mediaPipeline)

    def _build_model(self):
        return Tracker(self.pipeline.frame_size, self._config,
                      device=self.pipeline.device)

    def _view_enabled(self) -> bool:
        """Reference parity: blobs are drawn only when visual_mode > 0
        (default 0, gstnubotracker.cpp:383-390)."""
        return self._config.visual_mode > 0

    # tracker kmd methods (nubotracker.NuboTracker.kmd.json)
    def setThreshold(self, threshold: int):
        self._set(threshold=int(threshold))

    def setMinArea(self, minArea: int):
        self._set(min_area=int(minArea))

    def setMaxArea(self, maxArea: int):
        self._set(max_area=int(maxArea))

    def setDistance(self, distance: int):
        self._set(distance=int(distance))

    def setVisualMode(self, mode: int):
        self._set(visual_mode=int(mode))

    def activateServerEvents(self, activate: int, time: int):
        self._set(activate_events=int(activate), events_ms=int(time))
        self._rate = EventRateLimiter(int(time))

    def process(self, frames, stream: int = 0):
        with self._lock:
            model = self._ensure_model()
            res = model.process(frames, stream=stream)
        for blobs in res:
            self._emit([("tracker", b) for b in blobs])
        return res


@dataclasses.dataclass
class CnnDetectorConfig:
    """Knobs for the learned detector object (no reference analog — the
    reference ships only fixed cascades; this extends the module family)."""

    threshold: float | None = None  # objectness threshold; None → the
    #                                 measured serving operating point
    #                                 (models/cnn.SERVING_THRESHOLD)
    quantized: int = 0           # 1 → int8 serving path (models/quant.py)
    multi_scale: int = 0         # 1 → 320+640 two-scale inference
    detect_event: int = 0        # shared gating knobs (models/base.py)
    process_x_every_4_frames: int = 4
    view: int = 1
    activate_events: int = 0
    events_ms: int = 30001


class NuboCnnFaceDetector(_FilterObject):
    """The trained CNN face detector as a remote object: same OnFace event
    surface as NuboFaceDetector, learned device path (models/cnn.py), with
    an optional int8 serving mode."""

    EVENT_NAME = "OnFace"
    INFO_NAME = "face"

    def __init__(self, mediaPipeline):
        self._config = CnnDetectorConfig()
        self._overlay = None
        super().__init__(mediaPipeline)

    def _build_model(self):
        from ..models.cnn import CnnFaceDetector
        from ..models.quant import QuantizedCnnFaceDetector

        cls = (QuantizedCnnFaceDetector if self._config.quantized
               else CnnFaceDetector)
        return cls(self.pipeline.frame_size,
                   threshold=self._config.threshold,
                   multi_scale=bool(self._config.multi_scale),
                   detect_event=self._config.detect_event,
                   process_x_every_4_frames=(
                       self._config.process_x_every_4_frames),
                   device=self.pipeline.device)

    def _reconfigure_model(self):
        from ..models.quant import QuantizedCnnFaceDetector

        want_quant = bool(self._config.quantized)
        if want_quant != isinstance(self._model, QuantizedCnnFaceDetector):
            # int8 ⇄ f32 swaps the device program class; temporal track
            # state AND scheduler clocks (GOP counter, event-gate budget)
            # carry over to the new model — like every other live setter
            old = self._model
            self._model = self._build_model()
            self._model.tracks = old.tracks
            self._model.gop.counter = old.gop.counter
            self._model.gate.budget = old.gate.budget
        else:
            self._model.reconfigure(
                threshold=self._config.threshold,
                multi_scale=bool(self._config.multi_scale),
                detect_event=self._config.detect_event,
                process_x_every_4_frames=(
                    self._config.process_x_every_4_frames))

    def showFaces(self, viewFaces: int):
        self._set(view=int(viewFaces))

    def setThreshold(self, threshold: float):
        self._set(threshold=float(threshold))

    def setQuantized(self, quantized: int):
        self._set(quantized=int(quantized))

    def setMultiScale(self, multiScale: int):
        self._set(multi_scale=int(multiScale))

    def process(self, frames, stream: int = 0, events=None):
        with self._lock:
            model = self._ensure_model()
            res = model.process(frames, stream=stream, events=events)
        for faces in res:
            self._emit([("face", f.rect()) for f in faces])
        return res
