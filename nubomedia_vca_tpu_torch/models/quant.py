"""Int8 serving variant of the learned detector — the PyTorch port of
``nubomedia_vca_tpu/models/quant.py``.

Weights are quantized offline, per output channel, symmetric int8
(``quantize_params``, numpy). Every layer's input is quantized per tensor
at run time by ``ops/cuda/quant_cuda.quantize_int8`` (the hand-written
kernel on the card, its plain version on the CPU): seven quantizations per
forward with the context conv. Each conv is an im2col of nine shifted
slices of the zero-padded NHWC int8 tensor and one ``torch._int_mm``
(int8 x int8 → int32, exact: |sum| ≤ 127² · 1152 < 2³¹); the head layers
are ``torch._int_mm`` directly. K and N are padded with zeros to multiples
of 8 and M to at least 17 rows, as ``_int_mm`` needs on CUDA.

The dequantization ``y * (xs * w_s) + b`` is rounded once: the JAX
package's XLA:CPU program fuses it into a float32 FMA, so the port computes
``float32(float64(float32(y)) * float64(xs * w_s) + float64(b))``, on the
CPU and the card alike. Every layer's int8 tensor then equals
``forward_int8`` on the JAX CPU backend bit for bit, and so do channels
0-3 of the output. XLA:CPU computes the output's 5-wide channel axis as a
4-lane vector with the FMA plus a scalar tail without it, so channel 4
(logh) differs from the port's by at most 1 ulp. The card's run equals the
CPU's bit for bit (``tests/test_torch_cnn.py``, ``chip_smoke.py``).

The per-tensor scales span the whole batch, so a frame's output depends
on the other frames of its batch (``bucket_pad`` repeats frames).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda.quant_cuda import quantize_int8
from .cnn import CnnFaceDetector, _conv_layers, same_pads


def _quant_weight_per_cout(w: np.ndarray, cout_axis: int):
    """Per-output-channel symmetric int8 weight quantization."""
    w = np.asarray(w, np.float32)
    red = tuple(a for a in range(w.ndim) if a != cout_axis)
    abs_max = np.max(np.abs(w), axis=red, keepdims=True)
    scale = np.maximum(abs_max, np.float32(1e-8)) / np.float32(127.0)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_params(params: dict) -> dict:
    """float32 checkpoint params (numpy) → int8 weights ``w_q``, float32
    per-output-channel scales ``w_s`` (keepdims shape) and float32 biases
    ``b``, as the JAX package's ``quantize_params``."""
    out = {}
    for name, _, _ in _conv_layers(params):
        q, s = _quant_weight_per_cout(params[name]["w"], 3)
        out[name] = {"w_q": q, "w_s": s, "b": np.asarray(params[name]["b"])}
    for name in ("head1", "head2"):
        q, s = _quant_weight_per_cout(params[name]["w"], 1)
        out[name] = {"w_q": q, "w_s": s, "b": np.asarray(params[name]["b"])}
    return out


def _pad_to(n: int, m: int = 8) -> int:
    return -(-n // m) * m


class QuantizedCnnFace(torch.nn.Module):
    """The int8 forward (``forward_int8``): gray [B,H,W] uint8 →
    [B,H/16,W/16,5] float32, from ``quantize_params`` output. Weight
    matrices are [K, N] int8 buffers in HWIO flatten order (kh, kw, cin),
    zero-padded to multiples of 8."""

    def __init__(self, qparams: dict):
        super().__init__()
        self.layers = _conv_layers(qparams)
        self.cout = {}
        for name, lw in qparams.items():
            w = np.asarray(lw["w_q"], np.int8)
            w = w.reshape(-1, w.shape[-1])                   # [K, N]
            self.cout[name] = w.shape[1]
            wp = np.zeros((_pad_to(w.shape[0]), _pad_to(w.shape[1])), np.int8)
            wp[:w.shape[0], :w.shape[1]] = w
            self.register_buffer(f"{name}_wq", torch.from_numpy(wp))
            self.register_buffer(f"{name}_ws", torch.tensor(
                np.asarray(lw["w_s"], np.float32).reshape(-1)))
            self.register_buffer(f"{name}_b", torch.tensor(
                np.asarray(lw["b"], np.float32)))

    def _matmul(self, q: torch.Tensor, xs: torch.Tensor,
                name: str) -> torch.Tensor:
        """int8 [M, K] (K unpadded) → dequantized float32 [M, cout]. On
        CUDA ``_int_mm`` takes K and N in multiples of 8 and M > 16."""
        w = getattr(self, f"{name}_wq")
        m = q.shape[0]
        if q.shape[1] != w.shape[0] or m <= 16:
            q = F.pad(q, (0, w.shape[0] - q.shape[1], 0, max(17 - m, 0)))
        y = torch._int_mm(q, w)[:m, :self.cout[name]]
        scale = xs * getattr(self, f"{name}_ws")             # float32
        b = getattr(self, f"{name}_b")
        return (y.to(torch.float32).double() * scale.double()
                + b.double()).float()

    def _conv(self, x: torch.Tensor, name: str, stride: int, dilation: int,
              taps: list | None) -> torch.Tensor:
        q, xs = quantize_int8(x)
        if taps is not None:
            taps.append((x, q, xs))
        B, H, W, C = q.shape
        (pt, pb), (pl, pr) = (same_pads(H, stride, dilation),
                              same_pads(W, stride, dilation))
        qp = F.pad(q, (0, 0, pl, pr, pt, pb))
        Ho, Wo = -(-H // stride), -(-W // stride)
        cols = torch.stack([
            qp[:, kh * dilation:kh * dilation + (Ho - 1) * stride + 1:stride,
               kw * dilation:kw * dilation + (Wo - 1) * stride + 1:stride]
            for kh in range(3) for kw in range(3)], dim=3)   # [B,Ho,Wo,9,C]
        y = self._matmul(cols.reshape(B * Ho * Wo, 9 * C), xs, name)
        return torch.relu(y).reshape(B, Ho, Wo, -1)

    def _dense(self, x: torch.Tensor, name: str,
               taps: list | None) -> torch.Tensor:
        q, xs = quantize_int8(x)
        if taps is not None:
            taps.append((x, q, xs))
        return self._matmul(q.reshape(-1, q.shape[-1]), xs, name).reshape(
            *q.shape[:-1], -1)

    @torch.no_grad()
    def forward(self, gray: torch.Tensor,
                taps: list | None = None) -> torch.Tensor:
        """taps: a list that receives, layer by layer, the float32 input
        and its quantization (values int8, scale) — seven layers with the
        context conv."""
        x = (gray.to(torch.float32) / 128.0 - 1.0)[..., None]   # NHWC
        for name, stride, dilation in self.layers:
            y = self._conv(x, name, stride, dilation, taps)
            x = x + y if name == "ctx" else y
        h = torch.relu(self._dense(x, "head1", taps))
        return self._dense(h, "head2", taps)


class QuantizedCnnFaceDetector(CnnFaceDetector):
    """Drop-in int8 variant of ``CnnFaceDetector``: the same
    ``process``/``detect_boxes`` surface, forward = ``QuantizedCnnFace``
    over ``quantize_params(params)``."""

    def _make_model(self) -> torch.nn.Module:
        return QuantizedCnnFace(quantize_params(self.params))


def size_report(params: dict) -> dict:
    """Bytes of float32 vs int8 parameter storage (weights only)."""
    f32 = sum(np.asarray(params[k]["w"]).nbytes
              for k in params if "w" in params[k])
    qp = quantize_params(params)
    q = sum(qp[k]["w_q"].nbytes + qp[k]["w_s"].nbytes for k in qp)
    return {"f32_bytes": int(f32), "int8_bytes": int(q),
            "ratio": round(f32 / max(q, 1), 2)}
