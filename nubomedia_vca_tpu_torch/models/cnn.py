"""Learned face detector — the PyTorch port of
``nubomedia_vca_tpu/models/cnn.py``: its serving path and its training
half.

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

Training (``init_params``, ``CnnNet``, ``boxes_to_targets``, ``loss_fn``,
``make_optimizer``, ``train_step``, ``save_params_npz``) is torch autograd
through the same forward: ``CnnNet`` holds float32 master weights as
``nn.Parameter``s and casts them on each call as the JAX forward does, so
the backward of each cast rounds the gradient to bf16 where JAX's bf16
operands do. ``CnnFace`` is the same module under ``no_grad``. The
distillation trainer is ``models/distill.py``, the part trainer
``models/cnn_parts.py``.

``reconfigure`` changes the knobs of a live detector, as the remote
object's setters do. Host code is copied from the JAX package.
"""

from __future__ import annotations

import math
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


def save_params_npz(path: str, params: dict) -> None:
    """Nested parameter dict → the JAX package's flat-key npz checkpoint
    ("conv0/w" HWIO, ...), which ``load_params_npz`` of either package
    reads."""
    np.savez(path, **{f"{name}/{leaf}": np.asarray(v, np.float32)
                      for name, layer in params.items()
                      for leaf, v in layer.items()})


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


def params_to_numpy(flat: dict[str, torch.Tensor]) -> dict:
    """The inverse of ``params_from_numpy``: flat tensors on any device
    (``CnnNet.state_dict()``) → the JAX package's nested dict of float32
    numpy arrays, conv weights back to HWIO."""
    params: dict = {}
    for key, t in flat.items():
        name, leaf = key.split(".")
        a = t.detach().cpu().float()
        if a.ndim == 4:
            a = a.permute(2, 3, 1, 0)
        params.setdefault(name, {})[leaf] = np.ascontiguousarray(a.numpy())
    return params


def _conv_layers(params) -> list[tuple[str, int, int]]:
    """(name, stride, dilation) of the conv layers the checkpoint has."""
    layers = [(f"conv{i}", 2, 1) for i in range(4)]
    if "ctx" in params:
        layers.append(("ctx", 1, CTX_DILATION))
    return layers


class CnnNet(torch.nn.Module):
    """The differentiable bf16 forward (``cnn.forward``): gray [B,H,W]
    uint8 → [B,H/16,W/16,out] float32, out = 5 for the face model, C*5 for
    the part model. Each layer is a ``ParameterDict`` of float32 master
    weights, so ``state_dict()`` keys are ``params_from_numpy``'s
    ("conv0.w", ...). Every call casts them as the JAX forward does: conv
    weights and biases to bf16, head weights to bf16 values held in
    float32; activations enter the head as float32 and leave head1 rounded
    to bf16. The backward of each cast rounds its gradient to bf16, where
    the cotangents of JAX's bf16 operands are bf16.

    Its head is two float32 matmuls, so it refuses to be built when TF32
    would round them (``torch.backends.cuda.matmul.allow_tf32`` set or the
    float32 matmul precision not "highest"); it changes no global
    setting. The convs are bf16, which ``cudnn.allow_tf32`` does not
    touch."""

    def __init__(self, params: dict):
        _check_true_f32_matmul("CnnFaceDetector")
        super().__init__()
        self.layers = _conv_layers(params)
        flat = params_from_numpy(params)
        for name in params:
            self.add_module(name, torch.nn.ParameterDict({
                leaf: torch.nn.Parameter(flat[f"{name}.{leaf}"])
                for leaf in ("w", "b")}))

    def _conv(self, x: torch.Tensor, name: str, stride: int,
              dilation: int) -> torch.Tensor:
        layer = getattr(self, name)
        pt = same_pads(x.shape[2], stride, dilation)
        pl = same_pads(x.shape[3], stride, dilation)
        x = F.pad(x, (*pl, *pt))
        y = F.conv2d(x, layer["w"].to(torch.bfloat16), stride=stride,
                     dilation=dilation)
        return torch.relu(y + layer["b"].to(torch.bfloat16)[:, None, None])

    def forward(self, gray: torch.Tensor) -> torch.Tensor:
        x = (gray.to(torch.bfloat16) / 128.0 - 1.0)[:, None]   # NCHW
        for name, stride, dilation in self.layers:
            y = self._conv(x, name, stride, dilation)
            x = x + y if name == "ctx" else y
        x = x.permute(0, 2, 3, 1).float()                       # NHWC
        h = torch.relu(x @ self._head_weight("head1") + self.head1["b"])
        return (h.to(torch.bfloat16).float() @ self._head_weight("head2")
                + self.head2["b"])

    def _head_weight(self, name: str) -> torch.Tensor:
        """A head's weight as the forward uses it: bf16 values in
        float32."""
        return getattr(self, name)["w"].to(torch.bfloat16).float()


class CnnFace(CnnNet):
    """The serving forward: ``CnnNet`` under ``no_grad``, bit for bit the
    same values. It holds its weights as the forward casts them (conv
    weights and biases in bf16, head weights as bf16 values in float32),
    so a call launches no cast of a weight."""

    def __init__(self, params: dict):
        super().__init__(params)
        for name, layer in self.named_children():
            for leaf, p in layer.items():
                if not name.startswith("head"):
                    p.data = p.data.to(torch.bfloat16)
                elif leaf == "w":
                    p.data = p.data.to(torch.bfloat16).float()
        self.requires_grad_(False)

    def _head_weight(self, name: str) -> torch.Tensor:
        return getattr(self, name)["w"]

    @torch.no_grad()
    def forward(self, gray: torch.Tensor) -> torch.Tensor:
        return super().forward(gray)


# ------------------------------------------------------------- training
def init_params(generator: torch.Generator, channels=(16, 32, 64, 128),
                head_dim: int = 256, ctx: bool = False) -> dict:
    """``cnn.init_params``: 4 stride-2 3x3 convs, head 1x1 → head_dim → 5,
    and with ctx=True the residual dilated context conv; He-normal conv
    and head1 weights, head2 weights N(0, 0.01²), zero biases. Returns the
    JAX package's nested dict of float32 numpy arrays (conv weights HWIO).
    The values come from `generator` (CPU), so they match the JAX
    package's keys, shapes and scales, not its PRNG's draws."""
    def normal(shape, scale):
        return (torch.randn(shape, generator=generator) * scale).numpy()

    params = {}
    cin = 1
    for i, c in enumerate(channels):
        params[f"conv{i}"] = {"w": normal((3, 3, cin, c),
                                          np.sqrt(2.0 / (9 * cin))),
                              "b": np.zeros((c,), np.float32)}
        cin = c
    params["head1"] = {"w": normal((cin, head_dim), np.sqrt(2.0 / cin)),
                       "b": np.zeros((head_dim,), np.float32)}
    params["head2"] = {"w": normal((head_dim, 5), 0.01),
                       "b": np.zeros((5,), np.float32)}
    if ctx:
        params["ctx"] = {"w": normal((3, 3, cin, cin),
                                     np.sqrt(2.0 / (9 * cin))),
                         "b": np.zeros((cin,), np.float32)}
    return params


# XLA:CPU's float32 log (the Cephes polynomial, with the FMAs its program
# contracts), so that targets equal the JAX package's bit for bit: torch's
# log is correctly rounded and differs from it in about 2% of box widths.
# The constants are the float32 values XLA uses.
_LOG_P = [float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_LOG_Q1, _LOG_Q2 = float(np.float32(-2.12194440e-4)), 0.693359375
_SQRT_HALF = float(np.float32(0.707106781186547524))


def _fma(a, b, c) -> torch.Tensor:
    """XLA's float32 fused multiply-add: a*b + c in float64 (a*b of two
    float32 values is exact there), rounded to float32. The float64 sum's
    own rounding could only matter on a float32 tie, which no value of
    ``tests/test_torch_train.py`` meets. a, b, c: float32 tensors or
    float32-representable floats."""
    a, b, c = (v.double() if isinstance(v, torch.Tensor) else v
               for v in (a, b, c))
    return (a * b + c).to(torch.float32)


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """log of positive normal float32 values, as XLA:CPU computes it."""
    m, e = torch.frexp(x)
    low = m < _SQRT_HALF
    e = e.to(torch.float32) - low.to(torch.float32)
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(_fma(p[0], m, p[1]), m, p[2])
    y1 = _fma(_fma(p[3], m, p[4]), m, p[5])
    y2 = _fma(_fma(p[6], m, p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    return _fma(e, _LOG_Q2, (m - 0.5 * x2) + y)


# the 3x3 neighbourhood: neighbours first, the center (0, 0) LAST so its
# regression wins conflicts
_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if (dy, dx) != (0, 0)] + [(0, 0)]


def boxes_to_targets(boxes: torch.Tensor, valid: torch.Tensor, img_h: int,
                     img_w: int, ignore_boxes: torch.Tensor | None = None,
                     ignore_valid: torch.Tensor | None = None):
    """[B,N,4] float32 boxes (x, y, w, h) + [B,N] valid → detection-grid
    targets on the boxes' device, equal to the JAX package's
    ``boxes_to_targets`` bit for bit.

    obj [B,gh,gw] ∈ {1, -1, -2, 0}: 1 = center cell (positive), -1 = a
    cell of the 3x3 ring around a center (no objectness loss, but
    regression-supervised), -2 = inside an ignore box (no gradient at
    all), 0 = negative. reg [B,gh,gw,4]: center offset within the cell's
    own frame / STRIDE and log w/h relative to STRIDE, written over the
    whole 3x3 neighbourhood.

    Scatter order is XLA:CPU's: within each of the 9 offsets the highest
    box index writes last (a duplicate cell takes its value), and the
    offsets write in ``_OFFSETS`` order. An invalid (zero-padded) box
    writes back the value its cell held before that offset's scatter, so
    it can undo a lower-indexed valid box's write to the same cell in
    that offset (a face near the top-left corner shares cell (0, 0) with
    the padding boxes): inherited behaviour of the JAX package,
    reproduced and not fixed."""
    gh, gw = img_h // STRIDE, img_w // STRIDE
    B, N = valid.shape
    dev = boxes.device
    boxes = boxes.to(torch.float32)
    cells = B * gh * gw
    pos = torch.zeros(cells, device=dev)
    nb = torch.zeros(cells, device=dev)
    reg = torch.zeros(cells + 1, 4, device=dev)  # last row: shadowed writes
    cx = boxes[..., 0] + boxes[..., 2] / 2.0
    cy = boxes[..., 1] + boxes[..., 3] / 2.0
    gx = (cx / STRIDE).to(torch.int32).clamp(0, gw - 1)
    gy = (cy / STRIDE).to(torch.int32).clamp(0, gh - 1)
    logw = _xla_log(boxes[..., 2].clamp(min=1) / STRIDE)
    logh = _xla_log(boxes[..., 3].clamp(min=1) / STRIDE)
    base = torch.arange(B, device=dev)[:, None] * (gh * gw)
    idx = torch.arange(N, device=dev)
    later = idx[None, :] > idx[:, None]          # [n, n']: n' after n
    vf = valid.to(torch.float32).flatten()
    for dy, dx in _OFFSETS:
        gyn = (gy + dy).clamp(0, gh - 1)
        gxn = (gx + dx).clamp(0, gw - 1)
        t = torch.stack([cx / STRIDE - gxn, cy / STRIDE - gyn, logw, logh],
                        dim=-1)
        cell = base + gyn * gw + gxn              # [B,N]
        val = torch.where(valid[..., None], t, reg[cell])
        shadowed = ((cell[:, :, None] == cell[:, None, :]) & later).any(-1)
        reg[torch.where(shadowed, cells, cell)] = val
        nb.scatter_reduce_(0, cell.flatten(), vf, "amax")
        if (dy, dx) == (0, 0):
            pos.scatter_reduce_(0, cell.flatten(), vf, "amax")
    obj = (pos - nb * (1.0 - pos)).reshape(B, gh, gw)
    if ignore_boxes is not None:
        ignore_boxes = ignore_boxes.to(torch.float32)
        xs = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) * STRIDE
        ys = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5) * STRIDE
        x0, y0 = ignore_boxes[..., 0], ignore_boxes[..., 1]
        x1, y1 = x0 + ignore_boxes[..., 2], y0 + ignore_boxes[..., 3]
        inx = (xs >= x0[..., None]) & (xs <= x1[..., None])   # [B,N,gw]
        iny = (ys >= y0[..., None]) & (ys <= y1[..., None])   # [B,N,gh]
        cover = (inx[:, :, None, :] & iny[:, :, :, None]
                 & ignore_valid[..., None, None]).any(dim=1)  # [B,gh,gw]
        obj = torch.where((obj == 0) & cover, -2.0, obj)
    return obj, reg[:cells].reshape(B, gh, gw, 4)


POS_WEIGHT = 64.0  # positives are ~1:300 cells; unweighted BCE suppresses them
NEG_FOCAL = 8.0    # extra weight on confident false positives (see loss_fn)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, elementwise."""
    return (torch.relu(logits) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def loss_fn(model: torch.nn.Module, gray: torch.Tensor, obj_t: torch.Tensor,
            reg_t: torch.Tensor):
    """``cnn.loss_fn`` → (loss, (obj_loss, reg_loss)). obj_t ∈ {1, -1, -2,
    0} (positive / ignore-ring / ignore-box / negative, see
    ``boxes_to_targets``): the ring contributes regression but no
    objectness gradient, ignore boxes nothing. A negative cell scored near
    1 gets up to NEG_FOCAL extra weight; easy negatives keep weight 1."""
    pred = model(gray)
    obj_logit = pred[..., 0]
    pos = (obj_t > 0).float()
    ign = (obj_t < 0).float()
    regw = (pos + (obj_t == -1).float())[..., None]       # the 3x3 ring
    bce = sigmoid_bce(obj_logit, pos)
    p = torch.sigmoid(obj_logit).detach()
    neg_w = (1.0 + NEG_FOCAL * p.square()) * (1.0 - ign)
    obj_loss = (bce * torch.where(pos > 0, POS_WEIGHT, neg_w)).mean()
    reg_loss = ((pred[..., 1:] - reg_t).abs()
                * regw).sum() / regw.sum().clamp(min=1.0)
    return obj_loss + reg_loss, (obj_loss, reg_loss)


def warmup_cosine(steps: int):
    """The lr factor at update count k of
    ``optax.warmup_cosine_decay_schedule(0, lr, warmup, steps, 0.02 * lr)``
    with warmup = min(200, max(steps // 10, 1)): linear from 0, then a
    cosine over the remaining ``steps - warmup`` counts down to 2%."""
    warmup = min(200, max(steps // 10, 1))
    decay = steps - warmup
    if decay <= 0:
        raise ValueError("the cosine decay needs steps > warmup steps, got "
                         f"steps={steps}")

    def factor(k: int) -> float:
        if k < warmup:
            return k / warmup
        t = min(k - warmup, decay)
        return 0.98 * 0.5 * (1.0 + math.cos(math.pi * t / decay)) + 0.02

    return factor


def make_optimizer(parameters, lr: float = 3e-4, steps: int | None = None):
    """``cnn.make_optimizer`` → (AdamW, LambdaLR): optax's adamw (betas
    0.9/0.999, eps 1e-8, weight decay 1e-4 on every parameter, biases
    included) at a constant lr, or, when the step count is known, on the
    warmup-cosine schedule (``warmup_cosine``). Count 0 gives lr 0, so
    the first step moves nothing, as in optax. Call the scheduler's
    ``step()`` after each optimizer step (``train_step`` does)."""
    opt = torch.optim.AdamW(parameters, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    factor = warmup_cosine(steps) if steps else (lambda k: 1.0)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def train_step(model: torch.nn.Module, optimizer, scheduler,
               gray: torch.Tensor, obj_t: torch.Tensor, reg_t: torch.Tensor,
               loss=loss_fn):
    """One update: the loss's gradient, AdamW, the schedule's next count.
    Returns (loss, (obj_loss, reg_loss)), detached, on the model's device
    (nothing is read back to the host)."""
    optimizer.zero_grad(set_to_none=True)
    total, (obj_loss, reg_loss) = loss(model, gray, obj_t, reg_t)
    total.backward()
    optimizer.step()
    scheduler.step()
    return total.detach(), (obj_loss.detach(), reg_loss.detach())


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
