"""Real-image evaluation for the learned (CNN) detector family, on the
PyTorch port — the counterpart of ``tools/real_eval.py``.

Each image runs through BOTH the cascade teacher (frontalface_alt at a
160-px working width, factor 1.25, minNeighbors 3) and the CNN (bf16 or
int8, optionally multi-scale); the CNN's recall and precision are
reported against the teacher's boxes (IoU >= 0.5), per image and in
aggregate. ``--parts`` reports the one-pass multi-part detector's
per-class counts instead (its false positives on face-free photos).

  * --images DIR_OR_GLOB: photos (cv2 reads them; ``.npy`` uint8 arrays,
    gray [H, W] or BGR [H, W, 3], need no cv2);
  * --builtin: the offline photographs (``utils/offline_images.py``: the
    Grace Hopper portrait, scikit-learn's face-free china/flower scenes),
    where their readers are installed.

    python tools/torch_real_eval.py --builtin --device cpu
    python tools/torch_real_eval.py --images ~/photos/'*.jpg' --quantized

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from nubomedia_vca_tpu_torch.core.boxes import iou as _iou  # noqa: E402


def _load_gray(path_or_array) -> np.ndarray:
    """A photo as uint8 gray [H, W]: an array (gray, or BGR / BGRA as cv2
    reads it), an ``.npy`` file of one, or an image file read with cv2.
    BGR becomes gray with OpenCV's exact Q15 weights (``ops/color``)."""
    from nubomedia_vca_tpu_torch.ops.color import bgr_to_gray

    if isinstance(path_or_array, np.ndarray):
        img = path_or_array
    elif str(path_or_array).endswith(".npy"):
        img = np.load(path_or_array)
    else:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                f"reading {path_or_array} needs cv2, which is not installed; "
                "pass the photo as a uint8 .npy array instead") from e
        img = cv2.imread(path_or_array, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError(f"unreadable image {path_or_array}")
    if img.ndim == 3:
        img = bgr_to_gray(torch.from_numpy(np.ascontiguousarray(
            img[..., :3]))).numpy()
    return img.astype(np.uint8)


def _builtin_images():
    """The offline photographs whose readers are installed, as BGR arrays
    (so that _load_gray's luma weights match the BGR ingest path)."""
    from nubomedia_vca_tpu_torch.utils.offline_images import offline_photos

    photos = offline_photos()
    if not photos:
        raise SystemExit("no offline photographs found (matplotlib and "
                         "scikit-learn sample data both absent)")
    return [(p.name, p.bgr) for p in photos]


def evaluate(images, multi_scale=False, quantized=False, threshold=None,
             iou_gate=0.5, device="cuda", record: list | None = None):
    """CNN recall / precision against the cascade teacher over `images`
    [(name, path or array)] → (recall, precision, tp, fn, fp). With
    `record`, each image's (name, teacher boxes, CNN boxes) is appended
    to it."""
    from nubomedia_vca_tpu_torch.cascade.engine import get_engine
    from nubomedia_vca_tpu_torch.models.cnn import CnnFaceDetector
    from nubomedia_vca_tpu_torch.models.face import DEFAULT_FACE_CASCADE
    from nubomedia_vca_tpu_torch.models.quant import QuantizedCnnFaceDetector
    from nubomedia_vca_tpu_torch.ops.histogram import equalize_hist
    from nubomedia_vca_tpu_torch.ops.resize import resize_linear_exact

    tp = fn = fp = 0
    teachers, students = {}, {}
    rows = []
    for name, img in images:
        gray = _load_gray(img)
        h, w = gray.shape
        key = (w, h)
        if key not in teachers:
            work_w = min(160, w)
            work_h = int(round(h * work_w / w))
            teachers[key] = get_engine(DEFAULT_FACE_CASCADE,
                                       (work_w, work_h), 1.25, device=device)
            cls = QuantizedCnnFaceDetector if quantized else CnnFaceDetector
            students[key] = cls((w, h), threshold=threshold,
                                multi_scale=multi_scale, device=device)
        teacher, det = teachers[key], students[key]
        work = equalize_hist(resize_linear_exact(
            torch.from_numpy(np.ascontiguousarray(gray))[None].to(
                teacher.device), (teacher.image_w, teacher.image_h)))
        t_boxes = teacher.detect(work, 3)[0]
        t_boxes = np.rint(t_boxes * (w / teacher.image_w)).astype(int) \
            if len(t_boxes) else np.zeros((0, 4), int)
        s_boxes = det.detect_boxes(gray)[0]
        if record is not None:
            record.append((name, t_boxes, s_boxes))

        used = set()
        itp = ifn = 0
        for t in t_boxes:
            best = None
            for k, s in enumerate(s_boxes):
                if k in used:
                    continue
                if _iou(t, s) >= iou_gate:
                    best = k
                    break
            if best is None:
                ifn += 1
            else:
                itp += 1
                used.add(best)
        ifp = len(s_boxes) - len(used)
        tp, fn, fp = tp + itp, fn + ifn, fp + ifp
        rows.append((os.path.basename(str(name)), len(t_boxes),
                     len(s_boxes), itp, ifn, ifp))
        print(f"{rows[-1][0]}: teacher {len(t_boxes)} cnn {len(s_boxes)} "
              f"tp {itp} fn {ifn} fp {ifp}", flush=True)

    recall = tp / max(tp + fn, 1)
    precision = tp / max(tp + fp, 1)
    print(f"\naggregate: recall {recall:.3f} precision {precision:.3f} "
          f"(tp {tp} fn {fn} fp {fp}) over {len(rows)} images", flush=True)
    return recall, precision, tp, fn, fp


def evaluate_parts(images, threshold=None, device="cuda"):
    """Per-class detection counts of the one-pass multi-part detector
    (``models/cnn_parts.py``) over `images`: on face-free photos, its
    false positives → {class: count}."""
    from nubomedia_vca_tpu_torch.models.cnn_parts import (CLASSES,
                                                          CnnPartDetector)

    dets = {}
    totals = {k: 0 for k in CLASSES}
    for name, img in images:
        gray = _load_gray(img)
        h, w = gray.shape
        if (w, h) not in dets:
            dets[(w, h)] = CnnPartDetector((w, h), threshold=threshold,
                                           device=device)
        res = dets[(w, h)].process(gray)[0]
        row = {k: len(res[k]) for k in CLASSES}
        for k in CLASSES:
            totals[k] += row[k]
        print(f"{os.path.basename(str(name))}: " + " ".join(
            f"{k}={row[k]}" for k in CLASSES), flush=True)
    print("\naggregate FPs (face-free images): " + " ".join(
        f"{k}={totals[k]}" for k in CLASSES), flush=True)
    return totals


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", default=None,
                    help="directory or glob of photographs (or .npy arrays)")
    ap.add_argument("--builtin", action="store_true",
                    help="use the offline photographs (utils/offline_images)")
    ap.add_argument("--multi-scale", action="store_true")
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--parts", action="store_true",
                    help="evaluate the one-pass multi-part detector's "
                         "per-class FP counts instead of the face model")
    ap.add_argument("--threshold", type=float, default=None,
                    help="objectness threshold (default: the serving "
                         "operating points — cnn.SERVING_THRESHOLD for the "
                         "face model, per-class for --parts)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ns = ap.parse_args(argv)
    if ns.images:
        pat = (os.path.join(ns.images, "*") if os.path.isdir(ns.images)
               else ns.images)
        paths = sorted(glob.glob(os.path.expanduser(pat)))
        if not paths:
            raise SystemExit(f"no images match {pat}")
        images = [(p, p) for p in paths]
    elif ns.builtin:
        images = _builtin_images()
    else:
        ap.error("--images or --builtin required")
    if ns.parts:
        evaluate_parts(images, threshold=ns.threshold, device=ns.device)
    else:
        evaluate(images, ns.multi_scale, ns.quantized, ns.threshold,
                 device=ns.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
