"""Learned multi-part detector — the PyTorch port of
``nubomedia_vca_tpu/models/cnn_parts.py``: one conv pass for every part
class, and its trainer.

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
(``tests/test_torch_serving.py``).

Training is supervised on procedural scenes (``scene_with_parts``: exact
part geometry from ``models/synth.py``, drawn with cv2 on the host) and
runs on one device, the card unless the caller asks for another:

    python -m nubomedia_vca_tpu_torch.models.cnn_parts --steps 3000 \
        --out cnn_parts.npz

(``--init`` fine-tunes from a checkpoint). The step is ``cnn.train_step``
with this module's ``loss_fn`` at a constant lr.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..cascade.engine import _resolve_device
from ..core.boxes import iou
from . import cnn
from .base import bucket_pad
from .cnn import (CnnFace, CnnFaceDetector, decode, find_checkpoint,
                  letterbox_canvas, letterbox_params, load_params_npz, nms)

CLASSES = ("face", "eye", "nose", "mouth", "profile", "ear")
C = len(CLASSES)
W, H = CnnFaceDetector.WORK_W, CnnFaceDetector.WORK_H
MAX_PER_CLASS = 6
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


# ------------------------------------------------------------- training
def init_params(generator: torch.Generator, head_dim: int = 256) -> dict:
    """``cnn_parts.init_params``: the ``cnn.init_params`` backbone, a C*5
    head (N(0, 0.01²)) and the residual dilated context conv (He-normal),
    drawn from `generator` in that order. The context conv widens the
    per-cell receptive field from ~31 px to ~159 px: the profile/frontal
    distinction lives at head scale."""
    params = cnn.init_params(generator, head_dim=head_dim)
    params["head2"] = {
        "w": (torch.randn((head_dim, C * 5), generator=generator)
              * 0.01).numpy(),
        "b": np.zeros((C * 5,), np.float32)}
    cdim = params["head1"]["w"].shape[0]
    params["ctx"] = {
        "w": (torch.randn((3, 3, cdim, cdim), generator=generator)
              * np.sqrt(2.0 / (9 * cdim))).numpy(),
        "b": np.zeros((cdim,), np.float32)}
    return params


def scene_with_parts(rng):
    """320x240 scene + per-class padded boxes from exact synth geometry.

    Mixes frontal faces (face/eye/nose/mouth) and left-facing profile
    heads (profile/ear); the whole scene is then mirrored with 50%
    probability so the detector learns BOTH facing directions — the
    learned-family stand-in for the reference ear module's explicit
    flip-and-rerun pass (kmseardetect.cpp:796-803).

    Backgrounds mix flat noise with procedural textures
    (models/textures.py) so real-world high-frequency structure is a hard
    negative at training time — the texture-brittleness mitigation for
    tools/real_eval.py's round-3 finding."""
    from .synth import draw_face, draw_profile_face, _rects_overlap
    from .textures import any_bg

    img = any_bg(rng, W, H)
    boxes = {k: [] for k in CLASSES}
    heads: list = []            # placed head boxes (overlap exclusion)

    def place(s, margin):
        """Head position not overlapping prior heads, or None. Overlap
        occludes labeled parts under a later drawing — the model would be
        trained to hallucinate parts on blank skin."""
        for _ in range(8):
            cx = int(rng.randint(margin, W - margin))
            cy = int(rng.randint(s, H - s))
            cand = (cx - margin, cy - s, 2 * margin, 2 * s)
            if not any(_rects_overlap(cand, h) for h in heads):
                heads.append(cand)
                return cx, cy
        return None

    for _ in range(int(rng.randint(0, 3))):
        s = int(rng.randint(26, 70))
        pos = place(s, int(0.9 * s))
        if pos is None:
            continue
        geo = draw_face(img, pos[0], pos[1], s)
        boxes["face"].append(geo["face"])
        boxes["eye"].extend(geo["eyes"])
        boxes["nose"].append(geo["nose"])
        boxes["mouth"].append(geo["mouth"])
    for _ in range(int(rng.randint(0, 2))):
        s = int(rng.randint(26, 60))
        pos = place(s, int(0.95 * s))
        if pos is None:
            continue
        geo = draw_profile_face(img, pos[0], pos[1], s)
        boxes["profile"].append(geo["head"])
        boxes["ear"].append(geo["ear"])
    out = np.zeros((C, MAX_PER_CLASS, 4), np.float32)
    val = np.zeros((C, MAX_PER_CLASS), bool)
    for ci, k in enumerate(CLASSES):
        bs = boxes[k][:MAX_PER_CLASS]
        if bs:
            out[ci, :len(bs)] = bs
            val[ci, :len(bs)] = True
    if rng.rand() < 0.5:                      # mirror scene + boxes
        img = np.ascontiguousarray(img[:, ::-1])
        out[..., 0] = np.where(val, W - out[..., 0] - out[..., 2],
                               out[..., 0])
    return img, out, val


# Per-class positive-cell loss weight. Profile/ear instances are rare in
# the scene distribution (one profile head per ~2 scenes vs ~2 eyes per
# scene), so their positive gradients get boosted; eye's surplus recall
# (0.98 at the 0.90 gate) is traded back toward precision by damping its
# positive weight — measured on the v2 checkpoint where eye precision at
# the default threshold was the only gate failure.
CLASS_POS_WEIGHT = (1.0, 0.5, 1.0, 1.0, 2.0, 1.5)


def loss_fn(model: torch.nn.Module, gray: torch.Tensor,
            obj_t: torch.Tensor, reg_t: torch.Tensor):
    """obj_t [B,C,gh,gw], reg_t [B,C,gh,gw,4] (``cnn.loss_fn`` semantics
    per class, without the hard-negative term, the classes' positives
    weighted by CLASS_POS_WEIGHT) → (loss, (obj_loss, reg_loss)). `model`
    is a ``cnn.CnnNet`` with a C*5 head."""
    pred = model(gray)
    pred = pred.reshape(*pred.shape[:3], C, 5)             # [B,gh,gw,C,5]
    obj_logit = pred[..., 0].permute(0, 3, 1, 2)           # [B,C,gh,gw]
    reg = pred[..., 1:].permute(0, 3, 1, 2, 4)             # [B,C,gh,gw,4]
    pos = (obj_t > 0).float()
    ign = (obj_t < 0).float()     # ignore-ring (boxes_to_targets)
    regw = (pos + (obj_t == -1).float())[..., None]
    bce = cnn.sigmoid_bce(obj_logit, pos)
    cw = torch.tensor(CLASS_POS_WEIGHT, device=pred.device)[None, :, None,
                                                            None]
    obj_loss = (bce * torch.where(pos > 0, cnn.POS_WEIGHT * cw,
                                  1.0 - ign)).mean()
    reg_loss = ((reg - reg_t).abs()
                * regw).sum() / regw.sum().clamp(min=1.0)
    return obj_loss + reg_loss, (obj_loss, reg_loss)


def targets(boxes: torch.Tensor, valid: torch.Tensor):
    """[B,C,N,4] + [B,C,N] → per-class grids (obj [B,C,gh,gw], reg
    [B,C,gh,gw,4]): one ``cnn.boxes_to_targets`` call over the B*C rows,
    each row independent as under the JAX package's vmap over classes."""
    B, nc, N, _ = boxes.shape
    obj, reg = cnn.boxes_to_targets(boxes.reshape(B * nc, N, 4),
                                    valid.reshape(B * nc, N), H, W)
    return (obj.reshape(B, nc, *obj.shape[1:]),
            reg.reshape(B, nc, *reg.shape[1:]))


def train(steps: int = 3000, batch: int = 32, seed: int = 0, lr: float = 3e-4,
          out: str | None = None, n_pool: int = 12, regen_every: int = 50,
          log_every: int = 200, max_seconds: float | None = None,
          init: str | None = None, device: str | torch.device = "cuda"):
    """Supervised training at a constant lr → (params as the JAX package's
    nested numpy dict, final loss); ``init`` fine-tunes from an npz. A
    pool of ``n_pool`` batches with their targets lives on the device;
    every ``regen_every`` steps one entry is redrawn."""
    dev = _resolve_device(device)
    rng = np.random.RandomState(seed)
    params = (load_params_npz(init) if init
              else init_params(torch.Generator().manual_seed(seed)))
    model = cnn.CnnNet(params).to(dev)
    optimizer, scheduler = cnn.make_optimizer(model.parameters(), lr)

    def make_entry():
        scenes, bs, vs = zip(*[scene_with_parts(rng) for _ in range(batch)])
        obj_t, reg_t = targets(torch.from_numpy(np.stack(bs)).to(dev),
                               torch.from_numpy(np.stack(vs)).to(dev))
        return torch.from_numpy(np.stack(scenes)).to(dev), obj_t, reg_t

    pool = [make_entry() for _ in range(n_pool)]
    t0 = time.monotonic()
    loss = None
    for it in range(steps):
        if regen_every and it and it % regen_every == 0:
            pool[it // regen_every % n_pool] = make_entry()
        loss, _ = cnn.train_step(model, optimizer, scheduler,
                                 *pool[it % n_pool], loss=loss_fn)
        if log_every and it % log_every == 0:
            print(f"step {it}: loss {float(loss):.4f} "
                  f"({time.monotonic() - t0:.0f}s)", flush=True)
        if max_seconds is not None and time.monotonic() - t0 > max_seconds:
            print(f"time budget hit at step {it}", flush=True)
            break
    final = float(loss)
    print(f"final loss {final:.4f}", flush=True)
    params = cnn.params_to_numpy(model.state_dict())
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        cnn.save_params_npz(out, params)
        print(f"saved {out}", flush=True)
    return params, final


def evaluate(params=None, n_scenes: int = 48, seed: int = 123,
             threshold: float | dict | None = None, iou_gate: float = 0.4,
             device: str | torch.device = "cuda"):
    """Per-class recall/precision vs exact synth geometry."""
    det = CnnPartDetector((W, H), params=params, threshold=threshold,
                          device=device)
    rng = np.random.RandomState(seed)
    stats = {k: [0, 0, 0] for k in CLASSES}   # tp, fn, fp
    for _ in range(n_scenes):
        img, boxes, valid = scene_with_parts(rng)
        res = det.process(img)[0]
        for ci, k in enumerate(CLASSES):
            truth = [tuple(boxes[ci, j]) for j in range(MAX_PER_CLASS)
                     if valid[ci, j]]
            got = list(res[k])
            used = set()
            for t in truth:
                best = None
                for gi, g in enumerate(got):
                    if gi not in used and iou(t, g) >= iou_gate:
                        best = gi
                        break
                if best is None:
                    stats[k][1] += 1
                else:
                    stats[k][0] += 1
                    used.add(best)
            stats[k][2] += len(got) - len(used)
    for k, (tp, fn, fp) in stats.items():
        r = tp / max(tp + fn, 1)
        p = tp / max(tp + fp, 1)
        print(f"{k}: recall {r:.3f} precision {p:.3f} (tp {tp} fn {fn} "
              f"fp {fp})", flush=True)
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default="cnn_parts.npz")
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--max-seconds", type=float, default=None)
    ap.add_argument("--init", default=None,
                    help="checkpoint to fine-tune from (fresh init if "
                         "omitted)")
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    params, _ = train(ns.steps, ns.batch, ns.seed, ns.lr, out=ns.out,
                      max_seconds=ns.max_seconds, init=ns.init,
                      device=ns.device)
    if ns.eval:
        evaluate(params, device=ns.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
