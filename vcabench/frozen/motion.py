"""Synthetic traffic and CCTV footage for the motion tracker's cells,
drawn on the device from a seed: vehicles and pedestrians moving over a
static textured background, small flickering patches (foliage, rain,
codec blocks) and per-frame sensor noise.

* The background is a smooth random texture, still from frame to frame:
  only what moves, flickers or is noise changes a pixel, and the noise
  (at most ``noise`` each way, so two frames differ by at most twice
  that) stays under the tracker's threshold.
* A vehicle is a box with a darker window band and a stripe; a
  pedestrian a tall ellipse with a head. Each moves a whole number of
  pixels a frame along a straight line and stays inside the frame over
  the clip. In every stream the first two objects cross on one lane and
  the next two walk side by side, so that their blobs pass within the
  merge distance of each other; these four move all through the clip.
* Every stream plays the same scene: as many objects as the most movers
  a frame, of sizes spread evenly over the mix's range. Past the first
  four, each object stands (a car at a light, a pedestrian waiting) and
  moves for one stretch of the clip, so a frame has between the fewest
  and the most movers. A stream places the scene at a place of its own,
  over a background of its own, in tones of its own. The label
  propagation's work a frame follows the shapes of the motion, not
  where they lie, so a call costs about the same whichever stream it
  takes, and a window that holds about one round of calls does not
  depend on the order in which the seed deals the streams.
* A flicker patch is a square of 2-6 px whose brightness steps up or
  down for one frame (patches that overlap add their steps): two seeded
  components each (when it appears and when it goes), under the area
  filter's minimum.

``clips(mix, frame, seed, device)`` makes every stream's clip of a
traffic mix; ``layout(mix, frame, seed)`` the host part that places the
objects. Every seed draws the same set of streams (objects, places,
tones, backgrounds, flicker counts and sizes) in another order, with its
own noise and flicker positions, and so does alike work.

``frame_bytes(frame)`` is the least memory traffic of a frame of the
tracker's recurrence, for its roofline (``roofline.HBM_BYTES_PER_S``).
"""

from __future__ import annotations

import numpy as np
import torch


def frame_bytes(frame: tuple[int, int]) -> int:
    """Bytes a frame of the tracker must move at least: the frame and
    the previous frame (1 B a pixel each) and the float32 MHI (4 B) read,
    the MHI and the new previous frame written: 11 B a pixel."""
    w, h = frame
    return 11 * w * h


def _split(lo: int, hi: int, n: int, rng) -> list[int]:
    """n values spread evenly over [lo, hi], in a shuffled order."""
    vals = [lo + (i % (hi - lo + 1)) for i in range(n)]
    return [vals[i] for i in rng.permutation(n)]


def _range(lo: int, hi: int, what: str) -> tuple[int, int]:
    if lo > hi:
        raise ValueError(f"{what} does not fit the frame")
    return lo, hi


def _place(o: dict, W: int, H: int, rng, pad_x: int = 0) -> None:
    """Top-left x, y at frame 0 for an object that stays inside the
    frame over its moves, with `pad_x` more pixels free on its right."""
    span_x, span_y = o["vx"] * o["steps"], o["vy"] * o["steps"]
    x_lo, x_hi = _range(-min(0, span_x), W - o["w"] - pad_x - max(0, span_x),
                        f"a {o['kind']} of {o['w']}x{o['h']}")
    y_lo, y_hi = _range(-min(0, span_y), H - o["h"] - max(0, span_y),
                        f"a {o['kind']} of {o['w']}x{o['h']}")
    o["x"] = int(rng.randint(x_lo, x_hi + 1))
    o["y"] = int(rng.randint(y_lo, y_hi + 1))


def _cross(a: dict, b: dict, W: int, H: int, L: int, rng) -> None:
    """`b` comes the other way along `a`'s lane; their centres meet at a
    frame in the clip's middle third."""
    b["vx"] = -a["vx"]
    meet = int(rng.randint(L // 3, 2 * L // 3 + 1))
    reach = abs(a["vx"]) * max(meet, L - 1 - meet) + max(a["w"], b["w"]) // 2
    xm = int(rng.randint(*_range(reach + 1, W - reach - 1, "a crossing")))
    a["x"] = xm - a["w"] // 2 - a["vx"] * meet
    b["x"] = xm - b["w"] // 2 - b["vx"] * meet
    a["y"] = int(rng.randint(0, H - max(a["h"], b["h"]) + 1))
    b["y"] = int(np.clip(a["y"] + (a["h"] - b["h"]) // 2
                         + rng.randint(-8, 9), 0, H - b["h"]))


def _beside(a: dict, b: dict, W: int, H: int, rng) -> None:
    """`b` walks beside `a`, 3-11 px to its right, at the same pace."""
    gap = int(rng.randint(3, 12))
    b["vx"], b["vy"] = a["vx"], a["vy"]
    b["h"] = min(b["h"], a["h"])
    _place(a, W, H, rng, pad_x=gap + b["w"])
    b["x"] = a["x"] + a["w"] + gap
    b["y"] = a["y"] + (a["h"] - b["h"]) // 2


def _deck(lo: int, hi: int, n: int, rng) -> list[int]:
    """n sizes spread evenly over [lo, hi], each moved by up to a third
    of their spacing, in a shuffled order."""
    step = (hi - lo) / max(1, n - 1)
    sizes = np.linspace(lo, hi, n) + rng.uniform(-step / 3, step / 3, n)
    return np.clip(np.rint(sizes), lo, hi).astype(int)[
        rng.permutation(n)].tolist()


def _scene(mix: dict, frame: tuple[int, int], rng) -> list[dict]:
    """The objects every stream holds: kinds, sizes, paths and moving
    stretches (without tones)."""
    W, H = frame
    L = mix["clip_frames"]
    m_lo, m_hi = mix["objects_per_frame"]
    if m_lo < 4:
        raise ValueError("a stream's crossing and side-by-side pairs "
                         "need 4 movers a frame")
    v_lo, v_hi = mix["speed_px"]
    v_mid = (v_lo + v_hi) // 2
    # crossing vehicles, pedestrians side by side, then vehicles and
    # pedestrians in turn
    kinds = ["vehicle", "vehicle", "pedestrian", "pedestrian"] + [
        ("vehicle", "pedestrian")[k % 2] for k in range(m_hi - 4)]
    objs = []
    for kind, s in zip(kinds, _deck(*mix["object_size"], m_hi, rng)):
        w, h = (s, max(12, s // 2)) if kind == "vehicle" \
            else (max(8, s * 2 // 5), s)
        objs.append(dict(kind=kind, w=w, h=h, t_on=0, steps=L - 1))
    # past the fewest movers a frame, each object moves for one stretch
    n_extra = m_hi - m_lo
    stretches = [int(round((k + 1) * (L - 1) / (n_extra + 1)))
                 for k in range(n_extra)]
    for o, d in zip(objs[m_lo:], rng.permutation(stretches)):
        o["steps"] = int(d)
        o["t_on"] = int(rng.randint(0, L - 1 - d + 1))
    for k, o in enumerate(objs):
        # vehicles the faster half of the speeds, pedestrians the slower,
        # with more of a sideways drift
        if o["kind"] == "vehicle":
            vx = int(rng.randint(v_mid, v_hi + 1))
            vy = int(rng.randint(-1, 2))
        else:
            vx = int(rng.randint(v_lo, v_mid + 1))
            vy = int(rng.randint(-min(3, v_mid), min(3, v_mid) + 1))
        o["vx"] = vx * (1 if rng.rand() < 0.5 else -1)
        o["vy"] = 0 if k < 2 else vy
    _cross(objs[0], objs[1], W, H, L, rng)
    _beside(objs[2], objs[3], W, H, rng)
    for o in objs[4:]:
        _place(o, W, H, rng)
    return objs


def _extent(objs: list[dict]) -> tuple[int, int, int, int]:
    """x0, y0, x1, y1 (exclusive) of every place the objects take."""
    x0 = y0 = 1 << 30
    x1 = y1 = -x0
    for o in objs:
        for m in (0, o["steps"]):
            x, y = o["x"] + o["vx"] * m, o["y"] + o["vy"] * m
            x0, y0 = min(x0, x), min(y0, y)
            x1, y1 = max(x1, x + o["w"]), max(y1, y + o["h"])
    return x0, y0, x1, y1


def _streams(mix: dict, frame: tuple[int, int]) -> list[dict]:
    """The canonical streams of the mix, from a fixed generator: the
    scene, at a place of its own in each stream, with the stream's own
    tones, background and flicker counts."""
    W, H = frame
    rng = np.random.RandomState(0)
    scene = _scene(mix, frame, rng)
    x0, y0, x1, y1 = _extent(scene)
    if x0 < 0 or y0 < 0 or x1 > W or y1 > H:
        raise ValueError(f"the scene leaves {W}x{H} in a clip")
    f_lo, f_hi = mix["flicker_per_frame"]
    out = []
    for _ in range(mix["streams"]):
        dx = int(rng.randint(-x0, W - x1 + 1))
        dy = int(rng.randint(-y0, H - y1 + 1))
        objs = [dict(o, x=o["x"] + dx, y=o["y"] + dy,
                     value=int(rng.randint(0, 2)),
                     tone=int(rng.randint(45, 90))) for o in scene]
        out.append(dict(objects=objs,
                        flicker=_split(f_lo, f_hi, mix["clip_frames"], rng),
                        texture=int(rng.randint(0, 2 ** 31))))
    return out


def layout(mix: dict, frame: tuple[int, int], seed: int) -> list[dict]:
    """Per stream: its objects (top-left x, y at frame 0, size w x h,
    velocity vx, vy in pixels a frame, moving `steps` frames from frame
    `t_on`, standing before and after), its flicker patches a frame and
    its background's seed. The set of streams is fixed by the mix; the
    seed deals them to the streams in another order."""
    canon = _streams(mix, frame)
    order = np.random.RandomState(seed % (2 ** 32)).permutation(len(canon))
    return [canon[i] for i in order]


def _background(frame, texture: int, device) -> torch.Tensor:
    """[H, W] float32 in [70, 190]: a smooth texture (random fields at
    two scales, bilinearly upsampled), still over the clip."""
    W, H = frame
    gen = torch.Generator(device="cpu")
    gen.manual_seed(texture)
    out = torch.zeros((1, 1, H, W))
    for cells, amp in ((8, 45.0), (48, 15.0)):
        grid = torch.rand((1, 1, max(2, H * cells // W), cells),
                          generator=gen) * 2 - 1
        out += amp * torch.nn.functional.interpolate(
            grid, size=(H, W), mode="bilinear", align_corners=True)
    return (130.0 + out[0, 0]).clamp(70, 190).to(device)


def _parts(o: dict) -> list[tuple]:
    """The object as (kind, x0, y0, x1, y1, shade) in drawing order,
    offsets from its top-left, inclusive ends: boxes ('b') and ellipses
    ('e', inscribed in the box); shade is added to its base value."""
    w, h = o["w"], o["h"]
    if o["kind"] == "vehicle":
        return [("b", 0, 0, w - 1, h - 1, 0),
                ("b", w // 5, h // 8, w - 1 - w // 5, h * 3 // 8, -35),
                ("b", 0, h * 5 // 8, w - 1, h * 5 // 8 + max(1, h // 10),
                 25)]
    head = max(3, w * 3 // 5)
    return [("e", 0, head - 1, w - 1, h - 1, 0),
            ("e", (w - head) // 2, 0, (w - head) // 2 + head - 1,
             head - 1, 20)]


def draw_clip(stream: dict, frame: tuple[int, int], n_frames: int,
              mix: dict, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """[n_frames, H, W] uint8 of one stream: the background, the objects
    at their places (each shape drawn only inside the box its places
    cover; an object moves `steps` frames from frame `t_on`), the
    flicker patches at places drawn from `gen`, then noise
    in [-noise, noise] on every pixel of every frame."""
    W, H = frame
    bg = _background(frame, stream["texture"], device)
    img = bg.expand(n_frames, H, W).clone()
    t = torch.arange(n_frames, device=device)[:, None, None]
    for o in stream["objects"]:
        base = float(bg.mean()) + (o["tone"] if o["value"] else -o["tone"])
        span_x = sorted((0, o["vx"] * o["steps"]))
        span_y = sorted((0, o["vy"] * o["steps"]))
        moved = (t - o["t_on"]).clamp(0, o["steps"])
        for kind, px0, py0, px1, py1, shade in _parts(o):
            x0, x1 = o["x"] + px0 + span_x[0], o["x"] + px1 + span_x[1] + 1
            y0, y1 = o["y"] + py0 + span_y[0], o["y"] + py1 + span_y[1] + 1
            xx = torch.arange(x0, x1, device=device)[None, None, :]
            yy = torch.arange(y0, y1, device=device)[None, :, None]
            ox, oy = o["x"] + o["vx"] * moved, o["y"] + o["vy"] * moved
            if kind == "b":
                inside = ((xx >= ox + px0) & (xx <= ox + px1)
                          & (yy >= oy + py0) & (yy <= oy + py1))
            else:
                cx, cy = (px0 + px1) / 2.0, (py0 + py1) / 2.0
                ax, ay = (px1 - px0 + 1) / 2.0, (py1 - py0 + 1) / 2.0
                inside = (((xx - ox - cx) / ax) ** 2
                          + ((yy - oy - cy) / ay) ** 2) <= 1.0
            region = img[:, y0:y1, x0:x1]
            img[:, y0:y1, x0:x1] = torch.where(
                inside, float(np.clip(base + shade, 0, 255)), region)
    img = torch.round(img)
    # flicker: per frame its count of patches, sizes and steps from the
    # mix's generator, places from the seed's
    sz_lo, sz_hi = mix["flicker_size"]
    st_lo, st_hi = mix["flicker_step"]
    rng = np.random.RandomState(stream["texture"] % (2 ** 32))
    counts = stream["flicker"]
    n = sum(counts)
    sizes = torch.from_numpy(rng.randint(sz_lo, sz_hi + 1, n)).to(device)
    steps = torch.from_numpy(rng.randint(st_lo, st_hi + 1, n)
                             * np.where(rng.rand(n) < 0.5, 1, -1)).to(device)
    frames = torch.repeat_interleave(
        torch.arange(n_frames, device=device),
        torch.tensor(counts, device=device))
    px = torch.randint(0, W - sz_hi, (n,), generator=gen, device=device)
    py = torch.randint(0, H - sz_hi, (n,), generator=gen, device=device)
    d = torch.arange(sz_hi, device=device)
    dy, dx = d[:, None].expand(sz_hi, sz_hi), d[None, :].expand(sz_hi, sz_hi)
    keep = (dy[None] < sizes[:, None, None]) & (dx[None] < sizes[:, None, None])
    f_idx = frames[:, None, None].expand_as(keep)[keep]
    y_idx = (py[:, None, None] + dy[None])[keep]
    x_idx = (px[:, None, None] + dx[None])[keep]
    step = steps[:, None, None].expand_as(keep)[keep].to(img.dtype)
    # patches that overlap in a frame add their steps (exact integer sums,
    # so the same seed gives the same frames on every device)
    delta = torch.zeros_like(img)
    delta.index_put_((f_idx, y_idx, x_idx), step, accumulate=True)
    img = (img + delta).clamp(0, 255)
    noise = mix["noise"]
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
    for i, stream in enumerate(lay):
        out[i] = draw_clip(stream, frame, mix["clip_frames"], mix, gen,
                           device)
    return out, lay
