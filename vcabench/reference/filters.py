"""Plain versions of the NUBOMEDIA-VCA face and eye filters for the
benchmark's check: per frame, what ``kms_face_detect_process_frame`` and
``kms_eye_detect_process_frame`` compute, on top of ``cascade.py``.

* face (kmsfacedetect.cpp:757-850, Faces.cpp:78-181): downscale to
  ``width-to-process``, equalize, detectMultiScale with factor
  ``1 + multi-scale-factor/100`` and minNeighbors, boxes scaled back and
  rounded, then the per-stream track association with its anti-vibration
  rules;
* eye (kmseyedetect.cpp:778-1064): faces at 160 wide (minNeighbors 3,
  min size 30x30), both eye cascades over the whole 320-wide image (factor
  1.1, min size 20x20), each face split into right and left halves with
  the forehead (25%) and chin (40%) cropped, the candidates inside a half
  grouped (minNeighbors 2), deduplicated, eyebrows dropped, one eye a
  half, the left eye's y aligned to the right's, then temporal smoothing
  (euclidean distance 7, previous boxes kept over one empty frame) and
  ``transform_2_global_coordinates``.

Imports nothing of the program under test.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import cascade as C


def _cv_round(x) -> int:
    return int(np.rint(x))


# -------------------------------------------------------------------- face
class Tracks:
    """Faces::track_faces of one stream (Faces.cpp:78-153): each previous
    face takes its nearest detection within the track threshold; a face
    that moved past the size-based limit (8/5/3 px by area) adopts the new
    box, one whose area changed by more than 15% adopts the new size at
    the old place, else the old box stays; detections left over get new
    ids; state is purged on an empty frame."""

    def __init__(self):
        self.faces: list[tuple] = []     # (x, y, w, h, id)
        self.next_id = 0

    @staticmethod
    def _center(f):
        return (f[0] + f[2] // 2, f[1] + f[3] // 2)

    @staticmethod
    def _dist(a, b) -> int:
        return int(np.sqrt((b[0] - a[0]) ** 2 + (b[1] - a[1]) ** 2))

    @staticmethod
    def _limit(a1: int, a2: int) -> int:
        big = max(a1, a2)
        return 8 if big > 5000 else 5 if big > 2500 else 3

    def update(self, boxes, track_threshold: int) -> list[tuple]:
        dets = [tuple(int(v) for v in b) for b in np.reshape(boxes, (-1, 4))]
        if not dets:
            self.faces = []
            return self.faces
        remaining = list(dets)
        out = []
        for prev in self.faces:
            best, best_d = None, track_threshold
            for cand in remaining:
                d = self._dist(self._center(cand), self._center(prev))
                if d < best_d:
                    best, best_d = cand, d
            if best is None:
                continue
            d = self._dist(self._center(prev), self._center(best))
            pa, ba = prev[2] * prev[3], best[2] * best[3]
            if self._limit(pa, ba) < d:
                out.append((*best, prev[4]))
            elif 15 < abs(pa - ba) * 100 // ba:
                out.append((prev[0], prev[1], best[2], best[3], prev[4]))
            else:
                out.append(prev)
            remaining.remove(best)
        for cand in remaining:
            out.append((*cand, self.next_id))
            self.next_id += 1
        self.faces = out
        return out


def _work_size(frame, width):
    w = min(width, frame[0])
    return w, int(round(frame[1] * w / frame[0]))


class FaceFilter:
    """The face filter on frames of `frame` size; ``prec`` as in
    ``cascade.Detector``."""

    def __init__(self, cfg: dict, cascade_dir: str, device, prec=torch.float32):
        self.cfg = cfg
        self.frame = tuple(cfg["frame"])
        self.work = _work_size(self.frame, cfg["width_to_process"])
        self.scale_back = self.frame[0] / self.work[0]
        self.det = C.Detector(
            C.load_cascade(os.path.join(cascade_dir, cfg["cascade"])),
            self.work, 1.0 + cfg["multi_scale_factor"] / 100.0,
            device=device, prec=prec)
        self.device = torch.device(device)
        self.tracks: dict[int, Tracks] = {}

    def detect(self, gray) -> list[np.ndarray]:
        """Host or device frames [B, H, W] uint8 → grouped boxes per frame
        in frame coordinates."""
        g = torch.as_tensor(np.asarray(gray)).to(self.device)
        work = C.equalize(C.resize_exact(g, *self.work))
        mn = self.cfg["min_neighbors"]
        out = []
        for cand in self.det.candidates(work):
            grouped = C.group_rectangles(cand, mn) if mn else cand
            out.append(np.rint(grouped * self.scale_back).astype(np.int64))
        return out

    def track(self, stream: int, boxes_per_frame) -> list[list[tuple]]:
        t = self.tracks.setdefault(stream, Tracks())
        return [list(t.update(b, self.cfg["track_threshold"]))
                for b in boxes_per_frame]


# --------------------------------------------------------------------- eye
class _EyeState:
    def __init__(self):
        self.prev = {"right": [], "left": []}
        self.empty = {"right": 0, "left": 0}


def _center(r):
    return (r[0] + r[2] // 2, r[1] + r[3] // 2)


def _contains_pt(p, r):
    return r[1] <= p[1] <= r[1] + r[3] and r[0] <= p[0] <= r[0] + r[2]


class EyeFilter:
    """The eye filter on frames of `frame` size."""

    TOP, DOWN = 25, 40

    def __init__(self, cfg: dict, cascade_dir: str, device, prec=torch.float32):
        self.cfg = cfg
        self.frame = tuple(cfg["frame"])
        self.face_size = _work_size(self.frame, cfg["face_width"])
        self.part_size = _work_size(self.frame, cfg["width_to_process"])
        self.f2p = self.part_size[0] / self.face_size[0]
        self.p2o = self.frame[0] / self.part_size[0]
        self.device = torch.device(device)
        load = lambda name: C.load_cascade(os.path.join(cascade_dir, name))
        self.face = C.Detector(
            load(cfg["face_cascade"]), self.face_size,
            1.0 + cfg["multi_scale_factor"] / 100.0,
            tuple(cfg["face_min_size"]), device=device, prec=prec)
        self.eyes = {side: C.Detector(
            load(cfg[f"{side}_cascade"]), self.part_size,
            cfg["part_scale_factor"], tuple(cfg["part_min_size"]),
            device=device, prec=prec) for side in ("right", "left")}
        self.states: dict[int, _EyeState] = {}

    def detect(self, gray) -> list[tuple]:
        """Frames → per frame (faces at face resolution, right-eye and
        left-eye candidates at part resolution)."""
        g = torch.as_tensor(np.asarray(gray)).to(self.device)
        fimg = C.equalize(C.resize_exact(g, *self.face_size))
        pimg = C.equalize(C.resize_exact(g, *self.part_size))
        faces = [C.group_rectangles(c, self.cfg["face_min_neighbors"])
                 for c in self.face.candidates(fimg)]
        right = self.eyes["right"].candidates(pimg)
        left = self.eyes["left"].candidates(pimg)
        return list(zip(faces, right, left))

    def _roi(self, cands, roi):
        x, y, w, h = roi
        inside = [c for c in cands if c[0] >= x and c[1] >= y
                  and c[0] + c[2] <= x + w and c[1] + c[3] <= y + h]
        if not inside:
            return []
        return [tuple(int(v) for v in g) for g in C.group_rectangles(
            np.array(inside), self.cfg["part_min_neighbors"])]

    @staticmethod
    def _merge_current(face, roi, eyes, right_eyes, is_left):
        """__merge_eyes_current_frame (kmseyedetect.cpp:778-862)."""
        eyes = list(eyes)
        i = len(eyes) - 1
        while i > 0:
            a, b = eyes[i], eyes[i - 1]
            if _contains_pt(_center(a), b) and a[2] * a[3] < b[2] * b[3]:
                del eyes[i]
            elif _contains_pt(_center(b), a) and b[2] * b[3] < a[2] * a[3]:
                del eyes[i - 1]
            i -= 1
        y_cut = face[3] * 60 // 100
        for idx in reversed(range(len(eyes))):
            if eyes[idx][1] - roi[1] < y_cut:
                if idx == 0 and len(eyes) == 1:
                    if is_left and right_eyes:
                        e = eyes[0]
                        eyes[0] = (e[0], right_eyes[0][1], e[2], e[3])
                else:
                    del eyes[idx]
        if len(eyes) > 1:
            mid = (roi[0] + roi[2] // 2, roi[1] + roi[3] // 2)
            eyes = [min(eyes, key=lambda e: np.hypot(
                _center(e)[0] - mid[0], _center(e)[1] - mid[1]))]
        if is_left and eyes and right_eyes:
            e = eyes[0]
            eyes[0] = (e[0], right_eyes[0][1], e[2], e[3])
        return eyes

    def _merge_consecutive(self, st: _EyeState, key, new):
        """__merge_eyes_consecutives_frames (kmseyedetect.cpp:864-900)
        with the empty-frame persistence of kmseyedetect.cpp:1034-1064."""
        prev = st.prev[key]
        if not new:
            if st.empty[key] < self.cfg["max_fps_without_detection"]:
                st.empty[key] += 1
                return list(prev)
            st.empty[key] = 0
            st.prev[key] = []
            return []
        st.empty[key] = 0
        res, remaining = [], list(new)
        for p in prev:
            pc = _center(p)
            hit = None
            for c in remaining:
                cc = _center(c)
                if np.hypot(cc[0] - pc[0], cc[1] - pc[1]) < \
                        self.cfg["euclidean_distance"]:
                    hit = c
                    break
            if hit is not None:
                res.append(p)
                remaining.remove(hit)
        res.extend(remaining)
        st.prev[key] = res
        return res

    def _global(self, rects):
        s = self.p2o
        return [(_cv_round(x * s), _cv_round(y * s), _cv_round((w - 1) * s),
                 _cv_round((h - 1) * s)) for (x, y, w, h) in rects]

    def frame_result(self, stream: int, det) -> dict:
        """One frame's detections (from ``detect``) → its eyes, advancing
        the stream's smoothing state."""
        st = self.states.setdefault(stream, _EyeState())
        faces, cand_r, cand_l = det
        pw, ph = self.part_size
        s = self.f2p
        out_r, out_l = [], []
        for fx, fy, fw, fh in np.reshape(faces, (-1, 4)):
            rx, ry = _cv_round(fx * s), _cv_round(fy * s)
            rw, rh = _cv_round(fw * s), _cv_round(fh * s)
            top = _cv_round(rh * self.TOP / 100)
            down = _cv_round(rh * self.DOWN / 100)

            def clip(x, y, w, h):
                x0, y0 = max(0, x), max(0, y)
                x1, y1 = min(pw, x + w), min(ph, y + h)
                return (x0, y0, max(0, x1 - x0), max(0, y1 - y0))

            half_r = clip(rx, ry + top, rw // 2, rh - top - down)
            half_l = clip(rx + rw // 2, ry + top, rw // 2, rh - top - down)
            face = (rx, ry, rw, rh)
            r = self._merge_current(face, half_r, self._roi(cand_r, half_r),
                                    [], False)
            l_ = self._merge_current(face, half_l, self._roi(cand_l, half_l),
                                     r, True)
            out_r.extend(r)
            out_l.extend(l_)
        out_r = self._merge_consecutive(st, "right", out_r)
        out_l = self._merge_consecutive(st, "left", out_l)
        return {"eye_right": self._global(out_r),
                "eye_left": self._global(out_l)}
