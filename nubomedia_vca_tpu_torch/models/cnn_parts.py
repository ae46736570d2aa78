"""Learned multi-part detector — the PyTorch port of the serving half of
``nubomedia_vca_tpu/models/cnn_parts.py``: one conv pass for every part
class.

The reference needs five chained cascade elements (face feeding eye/nose/
mouth via GstEvents, SURVEY.md §2.4.8, plus the ear module's own
profile-cascade + flip pass, kmseardetect.cpp:644-726) to produce part
boxes; the learned family collapses that into ONE forward: the
``models/cnn.py`` backbone and residual dilated context conv with a
C-class head ([B, gh, gw, C*5]: per-class objectness + box), so a single
forward yields every part of every face, frontal and profile, either facing
direction. The weights are the JAX package's shipped
``cnn_parts_v2.npz`` (a byte-identical copy in ``assets/checkpoints/``),
trained there on synthetic scenes only.

As in ``models/cnn.py`` the forward is bfloat16 with a float32 head, so it
matches the JAX package to a tolerance, not bit for bit
(``tests/test_torch_serving.py``). Training (``init_params``, ``loss_fn``,
``train``, ``scene_with_parts``, ``evaluate``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cascade.engine import _resolve_device
from .base import bucket_pad
from .cnn import (CnnFace, CnnFaceDetector, decode, find_checkpoint,
                  letterbox_canvas, letterbox_params, load_params_npz, nms)

CLASSES = ("face", "eye", "nose", "mouth", "profile", "ear")
C = len(CLASSES)
W, H = CnnFaceDetector.WORK_W, CnnFaceDetector.WORK_H
DEFAULT_CHECKPOINT = "cnn_parts_v2.npz"   # v2: + profile/ear classes

# Per-class serving operating points of the shipped checkpoint (the JAX
# package's threshold sweep on its holdout scenes). A scalar `threshold`
# overrides all classes (the remote object's setThreshold semantics); a
# dict overrides per class.
DEFAULT_THRESHOLDS = {"face": 0.7, "eye": 0.9, "nose": 0.7,
                      "mouth": 0.7, "profile": 0.5, "ear": 0.7}


class CnnParts(CnnFace):
    """``cnn_parts.forward``: gray [B,H,W] uint8 → [B, gh, gw, C, 5], the
    ``CnnFace`` forward (backbone, context conv, head) with the wide C*5
    head reshaped per class."""

    @torch.no_grad()
    def forward(self, gray: torch.Tensor) -> torch.Tensor:
        out = super().forward(gray)
        B, gh, gw, _ = out.shape
        return out.reshape(B, gh, gw, C, 5)


class CnnPartDetector:
    """One-pass learned part detector: process(gray) → per-frame dict
    {face/eye/nose/mouth/profile/ear: [(x,y,w,h), ...]} in original
    coordinates (the part-detector result surface of models/parts.py). It
    runs on the card unless the caller asks for another device; a CUDA
    request on a host without CUDA raises."""

    WORK_W, WORK_H = W, H
    TOP_K = 8
    # tighter per-class NMS than the face detector's: part instances never
    # overlap (distinct eyes/ears are disjoint), so boxes agreeing >0.3 are
    # duplicates of one instance
    NMS_IOU = 0.30

    def __init__(self, frame_size, params=None, checkpoint=None,
                 threshold: float | dict | None = None,
                 device: str | torch.device = "cuda"):
        self.device = _resolve_device(device)
        self.frame_w, self.frame_h = frame_size
        if params is None:
            path = checkpoint or find_checkpoint(DEFAULT_CHECKPOINT)
            if path is None:
                raise FileNotFoundError(
                    f"no cnn_parts checkpoint ({DEFAULT_CHECKPOINT}); pass "
                    "params= or checkpoint=")
            params = load_params_npz(path)
        self.params = params
        self.threshold = threshold
        per_class = dict(DEFAULT_THRESHOLDS)
        if isinstance(threshold, dict):
            per_class.update(threshold)
        elif threshold is not None:
            per_class = {k: float(threshold) for k in CLASSES}
        self.thresholds = tuple(per_class[k] for k in CLASSES)
        # aspect-preserving letterbox (same scheme as CnnFaceDetector)
        self._rw, self._rh, self._ox, self._oy = letterbox_params(
            self.frame_w, self.frame_h, self.WORK_W, self.WORK_H)
        self.scale_back = self.frame_w / self._rw
        self.model = CnnParts(params).to(self.device)

    def letterbox(self, gray: torch.Tensor) -> torch.Tensor:
        """[B,H,W] uint8 frames → the [B,240,320] canvas, edge-padded."""
        return letterbox_canvas(gray, self._rw, self._rh, self._ox, self._oy,
                                self.WORK_W, self.WORK_H)

    @torch.no_grad()
    def detect_device(self, gray: torch.Tensor):
        """[B,H,W] uint8 frames on the device → per class (boxes [B,K,4] in
        canvas pixels, scores [B,K], kept [B,K]): the forward, then each
        class's top-8 decode at its threshold and its NMS."""
        pred = self.model(self.letterbox(gray))
        outs = []
        for ci in range(C):
            boxes, scores, valid = decode(pred[..., ci, :],
                                          self.thresholds[ci],
                                          top_k=self.TOP_K)
            keep = nms(boxes, scores, valid, self.NMS_IOU)
            outs.append((boxes, scores, valid & keep))
        return outs

    def process(self, gray):
        gray = np.asarray(gray)
        if gray.ndim == 2:
            gray = gray[None]
        gray, n_real = bucket_pad(gray)
        outs = self.detect_device(
            torch.from_numpy(np.ascontiguousarray(gray)).to(self.device))
        host = [(b.cpu().numpy(), v.cpu().numpy()) for (b, _, v) in outs]
        results = []
        for i in range(n_real):
            frame = {}
            for ci, k in enumerate(CLASSES):
                boxes, valid = host[ci]
                kept = (boxes[i][valid[i]] - np.array(
                    [self._ox, self._oy, 0, 0], np.float32)) * self.scale_back
                frame[k] = [tuple(int(round(x)) for x in bx) for bx in kept]
            results.append(frame)
        return results
