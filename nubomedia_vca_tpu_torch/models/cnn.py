"""Learned face detector — the PyTorch port of the serving path of
``nubomedia_vca_tpu/models/cnn.py``.

An anchor-free conv detector on a 320x240 canvas (grid 20x15 at stride
16): four stride-2 3x3 convs, an optional residual 3x3 dilation-4 context
conv, and a two-layer head giving per cell (logit, dx, dy, logw, logh).
``CnnFaceDetector.process`` has the surface of ``FaceDetector.process``:
letterbox → forward → decode → in-content filter → greedy NMS on the
detector's device, then box un-letterboxing, GOP/event gating and track ids
on the host.

The forward is bfloat16 as in the JAX package: bf16 convs with bf16
outputs, bias and relu in bf16; the head multiplies bf16-valued tensors in
float32 (the JAX einsums accumulate in float32), which TF32 cannot change,
since bf16 values are exact in TF32. Sums run in another order than
XLA's, so the forward matches the JAX package to a tolerance, not bit for
bit (``tests/test_torch_cnn.py``). The int8 variant is ``models/quant.py``.

``reconfigure`` changes the knobs of a live detector, as the remote
object's setters do. Training (``init_params``, ``loss_fn``,
``train_step``, targets, the optimizer) is not ported yet. Host code is
copied from the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..cascade.engine import _check_true_f32_matmul, _resolve_device
from ..ops.resize import resize_linear_exact
from .base import EventGate, GopScheduler, bucket_pad, gated_gop_mask
from .face import FaceTracks

STRIDE = 16        # total downsample: detection grid cell size in pixels
CTX_DILATION = 4   # context conv: 3x3 dil-4 on the stride-16 grid
DEFAULT_CHECKPOINT = "cnn_face_v1.npz"
# Serving operating point of the shipped checkpoint (the JAX package's
# SERVING_THRESHOLD); an explicit threshold overrides it.
SERVING_THRESHOLD = 0.5
CHECKPOINT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "assets", "checkpoints"))


def find_checkpoint(name: str = DEFAULT_CHECKPOINT) -> str | None:
    """The port's bundled checkpoint of that name, else `name` itself as a
    path, else None."""
    for c in (os.path.join(CHECKPOINT_DIR, name), name):
        if os.path.exists(c):
            return os.path.normpath(c)
    return None


def load_params_npz(path: str) -> dict:
    """Flat-key npz checkpoint ("conv0/w", ...) → nested dict of numpy
    arrays, the layout of the JAX package's parameter pytree."""
    params: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = params
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(flat[key])
    return params


def letterbox_params(frame_w: int, frame_h: int,
                     work_w: int, work_h: int) -> tuple[int, int, int, int]:
    """Aspect-preserving fit of a frame into the working canvas →
    (rw, rh, ox, oy): the frame resizes to rw×rh and sits at (ox, oy);
    the rest of the canvas is padding."""
    s = min(work_w / frame_w, work_h / frame_h)
    rw = max(1, int(round(frame_w * s)))
    rh = max(1, int(round(frame_h * s)))
    return rw, rh, (work_w - rw) // 2, (work_h - rh) // 2


def letterbox_canvas(gray: torch.Tensor, rw: int, rh: int, ox: int, oy: int,
                     sw: int, sh: int) -> torch.Tensor:
    """[B,H,W] uint8 frames → [B,sh,sw]: exact resize to rw×rh, placed at
    (ox, oy), the rest of the canvas the content's edge replicated."""
    work = resize_linear_exact(gray, (rw, rh))
    if (rw, rh) == (sw, sh):
        return work
    dev = work.device
    rows = (torch.arange(sh, device=dev) - oy).clamp(0, rh - 1)
    cols = (torch.arange(sw, device=dev) - ox).clamp(0, rw - 1)
    return work[:, rows][:, :, cols]


def same_pads(size: int, stride: int, dilation: int = 1,
              k: int = 3) -> tuple[int, int]:
    """XLA's padding="SAME" along one axis → (low, high). A stride-2 3x3
    conv on an even size pads (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def params_from_numpy(params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's nested parameter dict (numpy arrays) → flat
    float32 tensors: conv weights HWIO → OIHW ("conv0.w", ...), head
    weights [in, out] ("head1.w", ...), biases ("conv0.b", ...)."""
    out = {}
    for name, layer in params.items():
        w = torch.tensor(np.asarray(layer["w"], np.float32))
        out[f"{name}.w"] = w.permute(3, 2, 0, 1).contiguous() \
            if w.ndim == 4 else w
        out[f"{name}.b"] = torch.tensor(np.asarray(layer["b"], np.float32))
    return out


def _conv_layers(params: dict) -> list[tuple[str, int, int]]:
    """(name, stride, dilation) of the conv layers the checkpoint has."""
    layers = [(f"conv{i}", 2, 1) for i in range(4)]
    if "ctx" in params:
        layers.append(("ctx", 1, CTX_DILATION))
    return layers


class CnnFace(torch.nn.Module):
    """The bf16 forward (``cnn.forward``): gray [B,H,W] uint8 →
    [B,H/16,W/16,5] float32. Weights are buffers; there is no training.
    Its head is two float32 matmuls, so it refuses to be built when TF32
    would round them (``torch.backends.cuda.matmul.allow_tf32`` set or the
    float32 matmul precision not "highest"); it changes no global
    setting."""

    def __init__(self, params: dict):
        _check_true_f32_matmul("CnnFaceDetector")
        super().__init__()
        self.layers = _conv_layers(params)
        for name, t in params_from_numpy(params).items():
            if not name.startswith("head"):
                t = t.to(torch.bfloat16)
            elif name.endswith(".w"):     # bf16 values held in float32
                t = t.to(torch.bfloat16).float()
            self.register_buffer(name.replace(".", "_"), t)

    def _conv(self, x: torch.Tensor, name: str, stride: int,
              dilation: int) -> torch.Tensor:
        pt = same_pads(x.shape[2], stride, dilation)
        pl = same_pads(x.shape[3], stride, dilation)
        x = F.pad(x, (*pl, *pt))
        y = F.conv2d(x, getattr(self, f"{name}_w"), stride=stride,
                     dilation=dilation)
        return torch.relu(y + getattr(self, f"{name}_b")[:, None, None])

    @torch.no_grad()
    def forward(self, gray: torch.Tensor) -> torch.Tensor:
        x = (gray.to(torch.bfloat16) / 128.0 - 1.0)[:, None]   # NCHW
        for name, stride, dilation in self.layers:
            y = self._conv(x, name, stride, dilation)
            x = x + y if name == "ctx" else y
        x = x.permute(0, 2, 3, 1).float()                       # NHWC
        h = torch.relu(x @ self.head1_w + self.head1_b)
        return h.to(torch.bfloat16).float() @ self.head2_w + self.head2_b


def decode(pred: torch.Tensor, threshold: float = 0.5, top_k: int = 32):
    """[B,gh,gw,5] → (boxes [B,K,4] float32 pixels (x, y, w, h), scores
    [B,K], valid [B,K]). The top k cells by score, ties taken lowest index
    first as ``jax.lax.top_k`` does (a stable descending sort)."""
    B, gh, gw, _ = pred.shape
    score = torch.sigmoid(pred[..., 0]).reshape(B, -1)
    vals, idx = torch.sort(score, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    gy, gx = idx // gw, idx % gw
    sel = torch.gather(pred.reshape(B, gh * gw, 5), 1,
                       idx[..., None].expand(-1, -1, 5))
    cx = (gx + sel[..., 1]) * STRIDE
    cy = (gy + sel[..., 2]) * STRIDE
    w = torch.exp(sel[..., 3]) * STRIDE
    h = torch.exp(sel[..., 4]) * STRIDE
    boxes = torch.stack([cx - w / 2, cy - h / 2, w, h], dim=-1)
    return boxes, vals, vals > threshold


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float = 0.45) -> torch.Tensor:
    """Greedy NMS per frame: boxes [B,K,4] in score order, valid [B,K] →
    keep [B,K]. A box is suppressed when a higher-scoring kept box overlaps
    it above the IoU threshold."""
    K = boxes.shape[1]
    x0, y0 = boxes[..., 0], boxes[..., 1]
    x1, y1 = x0 + boxes[..., 2], y0 + boxes[..., 3]
    area = boxes[..., 2].clamp(min=0) * boxes[..., 3].clamp(min=0)
    ix0 = torch.maximum(x0[:, :, None], x0[:, None, :])
    iy0 = torch.maximum(y0[:, :, None], y0[:, None, :])
    ix1 = torch.minimum(x1[:, :, None], x1[:, None, :])
    iy1 = torch.minimum(y1[:, :, None], y1[:, None, :])
    inter = (ix1 - ix0).clamp(min=0) * (iy1 - iy0).clamp(min=0)
    iou = inter / (area[:, :, None] + area[:, None, :] - inter).clamp(
        min=1e-9)
    rank = torch.arange(K, device=boxes.device)
    higher = (scores[:, None, :] > scores[:, :, None]) | (
        (scores[:, None, :] == scores[:, :, None])
        & (rank[None, :] < rank[:, None]))
    overlap = (iou > iou_threshold) & higher & valid[:, None, :]
    keep = valid.clone()
    for i in range(K):
        keep[:, i] &= ~(overlap[:, i] & keep).any(dim=1)
    return keep


class CnnFaceDetector:
    """Learned face detector with the ``FaceDetector.process`` surface (a
    list per frame of TrackedFace), on one device: the card unless the
    caller asks for another; a CUDA request without CUDA raises."""

    WORK_W, WORK_H = 320, 240    # grid 20x15 at STRIDE 16
    NMS_IOU = 0.35               # one face's neighbour-cell duplicates
    # two-scale option: + a 640-wide pass for faces under ~2 grid cells at
    # 320, merged by one NMS in canonical 320-space
    MULTI_SCALES = ((320, 240), (640, 480))

    def __init__(self, frame_size: tuple[int, int], params: dict | None = None,
                 checkpoint: str | None = None,
                 threshold: float | None = None,
                 n_streams: int = 1, multi_scale: bool = False,
                 detect_event: int = 0, process_x_every_4_frames: int = 4,
                 device: str | torch.device = "cuda"):
        self.device = _resolve_device(device)
        self.frame_w, self.frame_h = frame_size
        if params is None:
            path = checkpoint or find_checkpoint()
            if path is None:
                raise FileNotFoundError("no CNN checkpoint found; pass "
                                        "params= or checkpoint=")
            params = load_params_npz(path)
        self.params = params
        self.threshold = (SERVING_THRESHOLD if threshold is None
                          else float(threshold))
        self.multi_scale = bool(multi_scale)
        self._rw, self._rh, self._ox, self._oy = letterbox_params(
            self.frame_w, self.frame_h, self.WORK_W, self.WORK_H)
        self.scale_back = self.frame_w / self._rw
        self.tracks = [FaceTracks() for _ in range(n_streams)]
        self.gop = GopScheduler(process_x_every_4_frames)
        self.gate = EventGate(detect_event, process_x_every_4_frames,
                              scaled=False)
        self.model = self._make_model().to(self.device)

    def _make_model(self) -> torch.nn.Module:
        return CnnFace(self.params)

    def reconfigure(self, threshold: float | None = None,
                    multi_scale: bool | None = None,
                    detect_event: int | None = None,
                    process_x_every_4_frames: int | None = None) -> None:
        """Apply knob changes to the LIVE detector (track IDs, GOP clock
        and gate budget preserved). The forward runs eagerly, so the next
        batch reads the new threshold and scales: there is no compiled
        program to rebuild."""
        if threshold is not None:
            self.threshold = float(threshold)
        if multi_scale is not None:
            self.multi_scale = bool(multi_scale)
        if detect_event is not None:
            self.gate.enabled = bool(detect_event)
        if process_x_every_4_frames is not None:
            self.gop.x = int(process_x_every_4_frames)
            self.gate.x = int(process_x_every_4_frames)

    def _scales(self):
        return self.MULTI_SCALES if self.multi_scale \
            else ((self.WORK_W, self.WORK_H),)

    def letterbox(self, gray: torch.Tensor, k: int = 1) -> torch.Tensor:
        """[B,H,W] uint8 frames → the k-times canvas [B,240k,320k]: exact
        resize, then edge-replicated padding around the content."""
        return letterbox_canvas(gray, self._rw * k, self._rh * k,
                                self._ox * k, self._oy * k,
                                self.WORK_W * k, self.WORK_H * k)

    @torch.no_grad()
    def detect_device(self, gray: torch.Tensor):
        """[B,H,W] uint8 frames on the device → (boxes [B,K,4] in canonical
        320x240 canvas pixels, scores [B,K], kept [B,K]): every scale's
        forward and decode, detections centred in the letterbox padding
        dropped, one NMS across the scales."""
        all_boxes, all_scores, all_valid = [], [], []
        for sw, sh in self._scales():
            k = sw // self.WORK_W
            pred = self.model(self.letterbox(gray, k))
            boxes, scores, valid = decode(pred, self.threshold)
            ox, oy = self._ox * k, self._oy * k
            cx = boxes[..., 0] + boxes[..., 2] * 0.5
            cy = boxes[..., 1] + boxes[..., 3] * 0.5
            inside = ((cx >= ox) & (cx < ox + self._rw * k)
                      & (cy >= oy) & (cy < oy + self._rh * k))
            all_boxes.append(boxes * (self.WORK_W / sw))
            all_scores.append(scores)
            all_valid.append(valid & inside)
        boxes = torch.cat(all_boxes, dim=1)
        scores = torch.cat(all_scores, dim=1)
        valid = torch.cat(all_valid, dim=1)
        return boxes, scores, valid & nms(boxes, scores, valid, self.NMS_IOU)

    def detect_boxes(self, gray) -> list[np.ndarray]:
        """NMS face boxes in frame coordinates, int32 [N,4] per frame. The
        batch is padded to a power-of-two bucket (base.bucket_pad), as in
        the JAX package: the per-tensor int8 scales span the batch."""
        gray = np.asarray(gray)
        if gray.ndim == 2:
            gray = gray[None]
        gray, n_real = bucket_pad(gray)
        boxes, _, valid = self.detect_device(
            torch.from_numpy(np.ascontiguousarray(gray)).to(self.device))
        boxes, valid = boxes.cpu().numpy(), valid.cpu().numpy()
        out = []
        for b in range(n_real):
            kept = boxes[b][valid[b]] - np.array(
                [self._ox, self._oy, 0, 0], np.float32)
            kept = kept * self.scale_back
            out.append(np.rint(kept).astype(np.int32)
                       if len(kept) else np.zeros((0, 4), np.int32))
        return out

    def process(self, gray, stream: int = 0, events=None):
        """Per-frame pipeline with GOP skip, event gate and tracking, the
        schedule of ``FaceDetector.process``."""
        gray = np.asarray(gray)
        if gray.ndim == 2:
            gray = gray[None]
        n = gray.shape[0]
        mask = gated_gop_mask(self.gop, self.gate, n, events)
        while stream >= len(self.tracks):
            self.tracks.append(FaceTracks())
        tracks = self.tracks[stream]
        results = []
        det_iter = iter(self.detect_boxes(gray[mask]) if mask.any() else [])
        for i in range(n):
            if mask[i]:
                results.append(list(tracks.update(next(det_iter), 40)))
            else:
                results.append(list(tracks.faces))
        return results
