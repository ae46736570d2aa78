"""Synthetic camera footage for the benchmark, drawn on the device from a
seed: cartoon frontal faces that OpenCV's ``haarcascade_frontalface_alt``
groups at 160x90 and whose eyes the ``haarcascade_{right,left}eye_2splits``
cascades find at 320x180, over a flat background, with per-frame sensor
noise.

The face follows ``utils/synth.draw_face`` of the program (face ellipse,
nose bar, mouth), with the eyes drawn as a dark socket, a brow, a pale
eye and a black iris, so that the eye cascades fire too. Everything is
vectorised over the frames of a clip; a face drifts a whole number of
pixels a frame.

``clips(mix, frame, seed, device)`` makes the clips of every stream of a
traffic mix; ``layout(mix, frame, seed)`` is the host part that places
the faces. Every seed draws the same set of streams (face counts, sizes,
places, drifts) in another order, with its own noise, and so does the
same work.
"""

from __future__ import annotations

import numpy as np
import torch

BG, SKIN = 170, 205

# the eye's shape, in units of the face's radius s (found by a search over
# these parameters that maximised the frames in which both the face and
# both eyes are found, at sizes 180 to 260 in 1280x720)
EYE = dict(ex=0.38, ey=0.044, sock=0.2, sock_v=165, brow_dy=0.283,
           brow_w=0.291, brow_h=0.068, brow_v=64, eye_w=0.121, eye_h=0.069,
           eye_v=177, iris=0.062, iris_v=27, blur=0.0107)


def layout(mix: dict, frame: tuple[int, int], seed: int) -> list[list[dict]]:
    """Per stream, its faces: start centre (cx, cy), radius s and drift
    (vx, vy) in pixels a frame. The set of streams is fixed by the mix
    (face counts, sizes, places and drifts, drawn once from a fixed
    generator), so that every seed does the same work; the seed deals
    them to the streams in another order."""
    canon = _streams(mix, frame)
    order = np.random.RandomState(seed % (2 ** 32)).permutation(len(canon))
    return [canon[i] for i in order]


def _streams(mix: dict, frame: tuple[int, int]) -> list[list[dict]]:
    W, H = frame
    n_streams, L = mix["streams"], mix["clip_frames"]
    lo, hi = mix["faces_per_frame"]
    counts = [lo + (i % (hi - lo + 1)) for i in range(n_streams)]
    rng = np.random.RandomState(0)
    counts = [counts[i] for i in rng.permutation(n_streams)]
    s_lo, s_hi = mix["face_size"]
    sizes = np.rint(np.linspace(s_lo, s_hi, sum(counts))).astype(int)
    sizes = sizes[rng.permutation(len(sizes))].tolist()
    d_lo, d_hi = mix["drift_px"]
    out = []
    for n in counts:
        faces = []
        for k in range(n):
            s = sizes.pop()
            # face k of n lives in the k-th vertical slice of the frame
            x0, x1 = W * k // n, W * (k + 1) // n
            half_w, half_h = int(0.78 * s) + 2, s + 2
            vx = int(rng.randint(d_lo, d_hi + 1)) * (1 if rng.rand() < 0.5 else -1)
            vy = int(rng.randint(0, 2)) * (1 if rng.rand() < 0.5 else -1)
            span_x, span_y = vx * (L - 1), vy * (L - 1)
            cx_lo = x0 + half_w - min(0, span_x)
            cx_hi = x1 - half_w - max(0, span_x)
            cy_lo = half_h - min(0, span_y)
            cy_hi = H - half_h - max(0, span_y)
            if cx_lo > cx_hi or cy_lo > cy_hi:
                raise ValueError(f"a face of radius {s} drifting ({vx}, {vy}) "
                                 f"does not fit its slice of {W}x{H}")
            faces.append(dict(cx=int(rng.randint(cx_lo, cx_hi + 1)),
                              cy=int(rng.randint(cy_lo, cy_hi + 1)),
                              s=int(s), vx=vx, vy=vy))
        out.append(faces)
    return out


def _primitives(s: int) -> list[tuple]:
    """The face of radius s as (kind, dx, dy, ax, ay, value) in drawing
    order: ellipses ('e', centre offset, semi-axes) and the nose bar ('b',
    inclusive box offsets x0, y0, x1, y1)."""
    e = EYE
    prims = [("e", 0, 0, int(0.78 * s), s, SKIN)]
    ey = -int(e["ey"] * s)
    for sx in (-1, 1):
        ex = sx * int(e["ex"] * s)
        prims += [
            ("e", ex, ey, int(e["sock"] * s), int(0.7 * e["sock"] * s),
             e["sock_v"]),
            ("e", ex, ey - int(e["brow_dy"] * s), int(e["brow_w"] * s),
             int(e["brow_h"] * s), e["brow_v"]),
            ("e", ex, ey, int(e["eye_w"] * s), int(e["eye_h"] * s),
             e["eye_v"]),
            ("e", ex, ey, int(e["iris"] * s),
             int(min(e["iris"], e["eye_h"]) * s), e["iris_v"]),
        ]
    t = max(1, s // 10)
    prims.append(("b", -(t // 2), -int(0.05 * s), (t - 1) // 2,
                  int(0.3 * s), 130))
    prims.append(("e", 0, int(0.55 * s), int(0.34 * s), int(0.12 * s), 70))
    return prims


def _blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [L, H, W] float32 (edges replicated)."""
    k = int(3 * sigma) + 1
    t = torch.arange(-k, k + 1, dtype=torch.float32, device=x.device)
    w = torch.exp(-t * t / (2 * sigma * sigma))
    w = (w / w.sum()).reshape(1, 1, -1)
    L, H, W = x.shape
    r = torch.nn.functional.pad(x.reshape(L * H, 1, W), (k, k),
                                mode="replicate")
    x = torch.nn.functional.conv1d(r, w).reshape(L, H, W)
    c = x.permute(0, 2, 1).reshape(L * W, 1, H)
    c = torch.nn.functional.pad(c, (k, k), mode="replicate")
    return torch.nn.functional.conv1d(c, w).reshape(L, W, H).permute(0, 2, 1)


def draw_clip(faces: list[dict], frame: tuple[int, int], n_frames: int,
              noise: int, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """[n_frames, H, W] uint8 of one stream: the faces at their drifting
    places, each blurred (sigma: ``EYE["blur"]`` times its radius), then
    noise in [-noise, noise] on every pixel of every frame. Each shape is
    drawn, and each face blurred, only inside the box its places cover."""
    W, H = frame
    t = torch.arange(n_frames, device=device)[:, None, None]
    img = torch.full((n_frames, H, W), float(BG), device=device)
    for f in faces:
        span_x = sorted((0, f["vx"] * (n_frames - 1)))
        span_y = sorted((0, f["vy"] * (n_frames - 1)))
        for kind, dx, dy, a, b, v in _primitives(f["s"]):
            if kind == "e":
                a, b = max(a, 1), max(b, 1)
                x0, x1 = f["cx"] + dx - a, f["cx"] + dx + a
                y0, y1 = f["cy"] + dy - b, f["cy"] + dy + b
            else:
                x0, x1 = f["cx"] + dx, f["cx"] + a
                y0, y1 = f["cy"] + dy, f["cy"] + b
            x0, x1 = max(x0 + span_x[0], 0), min(x1 + span_x[1] + 1, W)
            y0, y1 = max(y0 + span_y[0], 0), min(y1 + span_y[1] + 1, H)
            if x0 >= x1 or y0 >= y1:
                continue
            xx = torch.arange(x0, x1, device=device)[None, None, :]
            yy = torch.arange(y0, y1, device=device)[None, :, None]
            cx, cy = f["cx"] + f["vx"] * t, f["cy"] + f["vy"] * t
            if kind == "e":
                inside = (((xx - (cx + dx)) / a) ** 2
                          + ((yy - (cy + dy)) / b) ** 2) <= 1.0
            else:
                inside = ((xx >= cx + dx) & (xx <= cx + a)
                          & (yy >= cy + dy) & (yy <= cy + b))
            region = img[:, y0:y1, x0:x1]
            img[:, y0:y1, x0:x1] = torch.where(inside, float(v), region)
    for f in faces:
        # the background is flat: only the face's box changes under blur
        sigma = EYE["blur"] * f["s"]
        if sigma < 0.3:
            continue
        k = int(3 * sigma) + 2
        span_x = sorted((0, f["vx"] * (n_frames - 1)))
        span_y = sorted((0, f["vy"] * (n_frames - 1)))
        x0 = max(f["cx"] - int(0.78 * f["s"]) + span_x[0] - k, 0)
        x1 = min(f["cx"] + int(0.78 * f["s"]) + span_x[1] + k + 1, W)
        y0 = max(f["cy"] - f["s"] + span_y[0] - k, 0)
        y1 = min(f["cy"] + f["s"] + span_y[1] + k + 1, H)
        img[:, y0:y1, x0:x1] = _blur(img[:, y0:y1, x0:x1].contiguous(),
                                     sigma)
    img = torch.round(img)
    if noise:
        img = img + torch.randint(-noise, noise + 1, img.shape,
                                  generator=gen, device=device,
                                  dtype=torch.int16)
    return img.clamp(0, 255).to(torch.uint8)


def clips(mix: dict, frame: tuple[int, int], seed: int,
          device: torch.device) -> tuple[torch.Tensor, list]:
    """Every stream's clip, [streams, clip_frames, H, W] uint8 on
    `device`, and the layout it was drawn from."""
    lay = layout(mix, frame, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    out = torch.empty((len(lay), mix["clip_frames"], frame[1], frame[0]),
                      dtype=torch.uint8, device=device)
    for i, faces in enumerate(lay):
        out[i] = draw_clip(faces, frame, mix["clip_frames"], mix["noise"],
                           gen, device)
    return out, lay


def to_bgr(gray: torch.Tensor, tint) -> torch.Tensor:
    """[..., H, W] uint8 luma → [..., H, W, 3] uint8 BGR: each channel the
    luma plus its tint (b, g, r), clipped."""
    t = torch.tensor(tint, dtype=torch.int16, device=gray.device)
    return (gray.to(torch.int16)[..., None] + t).clamp(0, 255).to(
        torch.uint8)
