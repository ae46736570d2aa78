#!/usr/bin/env python
"""Window-level holdout eval of the SHIPPED trained cascade XMLs, on the
PyTorch port — the counterpart of ``tools/eval_trained_cascades.py``.

The port's bundled assets (``nubomedia_vca_tpu_torch/assets/haarcascades``,
byte-identical to the JAX package's) are loaded through the port's XML
loader and evaluated on freshly sampled holdout crops: detection on part
positives, and false positives on the clean scene negatives and on the
texture families (``models/synth``, ``models/textures``; both need cv2).
The feature values are the port's exact float32 GEMM
(``cascade/train.feature_values``) on ``--device``.

    python tools/torch_eval_trained_cascades.py [--seed 999] [--n-neg 3000]

prints one JSON line per part.

``--real`` instead runs the real-pixel false-positive sweep: each shipped
trained cascade (vca_nose/ear/profileface) and the bundled real
``haarcascade_profileface.xml`` scanned over the offline photographs
(``utils/offline_images.py``) at its serving configuration — part
cascades at the 320-wide part working width with the part pyramid factor
1.1 and minNeighbors 3, profile cascades at the 160-wide face width,
1.25, minNeighbors 2. The scan is whole-image (no face-ROI gating), so
the counts upper-bound serving FP exposure; on the portrait the count
outside the teacher face box is reported separately.

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ASSETS = os.path.join(os.path.dirname(__file__), "..",
                      "nubomedia_vca_tpu_torch", "assets", "haarcascades")
PARTS = {
    "nose": "vca_nose_synthetic.xml",
    "ear": "vca_ear_synthetic.xml",
    "profile": "vca_profileface_synthetic.xml",
}
REAL_PROFILE = os.path.join(ASSETS, "haarcascade_profileface.xml")


def eval_xml_windows(casc, samples: np.ndarray,
                     device="cuda") -> np.ndarray:
    """Boolean pass mask for [N,h,w] uint8 windows under the loaded
    cascade's exact semantics (normalized feature values, padded depth-2
    branch-free weak eval), minus the variance-validity gate (applied by
    the caller, as in the trainer). The feature values are the trainer's
    GEMM on `device`; the weak trees run on the host."""
    from nubomedia_vca_tpu_torch.cascade.train import (corner_matrix,
                                                       feature_values)
    assert not casc.has_tilted, "trained cascades are upright-only"
    feats = []
    for f in range(casc.n_features):
        rl = []
        for r in range(casc.rects.shape[1]):
            wt = float(casc.rect_weights[f, r])
            if wt == 0.0:
                continue
            x, y, w, h = (int(v) for v in casc.rects[f, r])
            rl.append((x, y, w, h, wt))
        feats.append(rl)
    mat = corner_matrix(feats, casc.window_w, casc.window_h)
    vals = feature_values(samples, mat, device=device)

    def weak_out(i):
        v0 = vals[:, casc.feat0[i]]
        left = np.where(vals[:, casc.featL[i]] < casc.thrL[i],
                        casc.leavesL[i, 0], casc.leavesL[i, 1])
        right = np.where(vals[:, casc.featR[i]] < casc.thrR[i],
                         casc.leavesR[i, 0], casc.leavesR[i, 1])
        return np.where(v0 < casc.thr0[i], left, right)

    alive = np.ones(samples.shape[0], bool)
    for s in range(casc.n_stages):
        idx = np.nonzero(casc.weak_stage == s)[0]
        score = np.zeros(samples.shape[0], np.float32)
        for i in idx:
            score += weak_out(i)
        alive &= score >= casc.stage_thresholds[s]
    return alive


def real_fp_scan(cascade_path: str, gray: np.ndarray, family: str,
                 face_box=None, device="cuda") -> dict:
    """Whole-image serving-config scan of one cascade over one photo.

    family 'part' → 320-wide work image, pyramid 1.1, minNeighbors 3;
    family 'profile' → 160-wide, 1.25, minNeighbors 2. Returns grouped
    detection counts in ORIGINAL pixels; with face_box (x,y,w,h),
    detections whose center lies inside the box are counted separately
    (not FPs for face-part cascades)."""
    from nubomedia_vca_tpu_torch.cascade.engine import get_engine
    from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist
    from nubomedia_vca_tpu_torch.ops.resize import resize_linear_exact

    h, w = gray.shape
    work_w, sf, mn = ((320, 1.1, 3) if family == "part"
                      else (160, 1.25, 2))
    work_w = min(work_w, w)
    work_h = int(round(h * work_w / w))
    eng = get_engine(cascade_path, (work_w, work_h), sf, device=device)
    work = equalize_hist(resize_linear_exact(
        torch.from_numpy(np.ascontiguousarray(gray))[None].to(eng.device),
        (work_w, work_h)))
    boxes = eng.detect(work, mn)[0]
    boxes = (np.rint(np.asarray(boxes, np.float64) * (w / work_w))
             .astype(int) if len(boxes) else np.zeros((0, 4), int))
    n_in_face = 0
    if face_box is not None and len(boxes):
        fx, fy, fw, fh = face_box
        cx = boxes[:, 0] + boxes[:, 2] / 2
        cy = boxes[:, 1] + boxes[:, 3] / 2
        inside = ((cx >= fx) & (cx < fx + fw)
                  & (cy >= fy) & (cy < fy + fh))
        n_in_face = int(inside.sum())
    return {"n_det": int(len(boxes)), "n_in_face": n_in_face,
            "n_fp": int(len(boxes)) - n_in_face,
            "boxes": [[int(v) for v in b] for b in boxes[:16]]}


def photo_gray(bgr: np.ndarray) -> np.ndarray:
    """The sweep's gray image of a BGR photo: the float luma weights,
    rounded half to even (as the JAX tool computes it)."""
    return np.round(bgr[..., 0] * 0.114 + bgr[..., 1] * 0.587
                    + bgr[..., 2] * 0.299).astype(np.uint8)


def sweep_scans() -> list[tuple[str, str, str]]:
    """(name, XML path, family) of every cascade the sweep scans."""
    return [("vca_nose", os.path.join(ASSETS, PARTS["nose"]), "part"),
            ("vca_ear", os.path.join(ASSETS, PARTS["ear"]), "part"),
            ("vca_profileface", os.path.join(ASSETS, PARTS["profile"]),
             "profile"),
            ("haarcascade_profileface", REAL_PROFILE, "profile")]


def run_real_sweep(device="cuda", photos=None) -> list[dict]:
    """The full real-photo FP sweep: every shipped trained cascade plus the
    bundled real profile cascade over every offline photograph (or over
    `photos`, objects with ``name``, ``bgr`` and ``n_faces``)."""
    from nubomedia_vca_tpu_torch.models.face import FaceDetector
    from nubomedia_vca_tpu_torch.utils.offline_images import offline_photos

    photos = offline_photos() if photos is None else photos
    rows = []
    for photo in photos:
        gray = photo_gray(photo.bgr)
        face_box = None
        if photo.n_faces:
            h, w = gray.shape
            faces = FaceDetector((w, h), device=device).process(
                gray[None])[0]
            if faces:
                f = faces[0]
                face_box = (f.x, f.y, f.w, f.h)
        for name, path, family in sweep_scans():
            row = {"cascade": name, "photo": photo.name, "family": family,
                   "face_box": list(face_box) if face_box else None}
            row.update(real_fp_scan(path, gray, family, face_box, device))
            rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=999)
    ap.add_argument("--n-pos", type=int, default=800)
    ap.add_argument("--n-neg", type=int, default=3000)
    ap.add_argument("--real", action="store_true",
                    help="real-photo FP sweep instead of the synthetic "
                         "holdout eval")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.real:
        for row in run_real_sweep(args.device):
            print(json.dumps(row), flush=True)
        return 0

    from nubomedia_vca_tpu_torch.cascade.train import vnf_and_valid
    from nubomedia_vca_tpu_torch.cascade.xml_loader import load_cascade_xml
    from nubomedia_vca_tpu_torch.models.synth import (make_samplers,
                                                      make_texture_sampler)

    for part, fname in PARTS.items():
        path = os.path.join(ASSETS, fname)
        casc = load_cascade_xml(path)
        rng = np.random.RandomState(args.seed)
        pos_s, _ = make_samplers(part, texture_neg_frac=0.0)
        clean_neg = make_samplers(part, texture_neg_frac=0.0)[1]
        tex_neg = make_texture_sampler()

        P = pos_s(args.n_pos, rng)
        _, pv = vnf_and_valid(P)
        det = float(eval_xml_windows(casc, P[pv], args.device).mean())
        fps = {}
        for name, sampler in (("clean", clean_neg), ("textured", tex_neg)):
            N = sampler(args.n_neg, rng)
            _, nv = vnf_and_valid(N)
            fps[name] = float(eval_xml_windows(casc, N[nv],
                                               args.device).mean())
        print(json.dumps({
            "part": part, "asset": fname, "stages": casc.n_stages,
            "weaks": casc.n_weaks, "det": round(det, 4),
            "fp_clean": round(fps["clean"], 5),
            "fp_textured": round(fps["textured"], 5),
            "n_pos": int(pv.sum()), "n_neg": args.n_neg,
            "seed": args.seed,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
