"""Plain Haar-cascade detection for the benchmark's check: the semantics of
``cv::CascadeClassifier::detectMultiScale`` followed by
``cv::groupRectangles``, written from OpenCV's description in plain
PyTorch (any device) and NumPy.

This module imports nothing of the program under test. It reads the
cascade XML files itself and makes every table from the frames it is
given.

Arithmetic, step by step:

* pyramid: the scale loop of detectMultiScale (factor 1, f, f^2, ...;
  window ``cvRound(w0 * factor)``; level image ``cvRound(W / factor)``;
  stride 1 above a factor of 2, else 2);
* level images: ``cv::resize(INTER_LINEAR_EXACT)``, fixed point: Q8
  horizontal and vertical weights, rounded once (``resize_exact``);
* integral tables in int64 (sum, squared sum, and the 45-degree tilted
  table of ``cv::integral``), so no rect sum wraps;
* variance normalisation on the window's inner rect (1, 1, w-2, h-2):
  ``nf = area * sqsum - sum^2`` in float32, a window with
  ``nf <= 100 * area^2`` rejected, ``vnf = 1 / sqrt(nf)`` rounded to
  float32;
* a feature: ``w0*s0 + w1*s1 (+ w2*s2)`` in float32, times vnf in float32,
  compared ``<`` with the node's float32 threshold;
* a stage: the trees' leaves summed one by one in float32, in the trees'
  order, and the window passes while the sum is ``>=`` the stage
  threshold. This is the JAX package's arithmetic, which the program
  follows; OpenCV's ``predictOrdered`` sums in double, and the two part on
  windows within a few float32 ulps of a threshold;
* ``prec`` switches the product with vnf, the comparisons and the stage
  sums to bfloat16 for the lower-precision control;
* grouping: similarity classes of SimilarRects (eps 0.2) by transitive
  closure, ordered by their first member; each class's mean rect, each
  coordinate ``sum / n`` rounded half to even; classes of at most
  ``min_neighbors`` members dropped, and a class inside a stronger one
  suppressed.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np
import torch


# ----------------------------------------------------------------- cascade
@dataclasses.dataclass
class Cascade:
    """One cascade read from its XML file (OpenCV's new format)."""

    window: tuple[int, int]            # (w, h)
    rects: np.ndarray                  # [F, 3, 4] int64 x, y, w, h
    weights: np.ndarray                # [F, 3] float32, 0 where absent
    tilted: np.ndarray                 # [F] bool
    # per tree: root, left, right node (feature, threshold); a child that
    # is a leaf has threshold +inf and both its leaves equal
    tree_feat: np.ndarray              # [T, 3] int64
    tree_thr: np.ndarray               # [T, 3] float32
    tree_leaf: np.ndarray              # [T, 4] float32: left a/b, right a/b
    stage_first: np.ndarray            # [S + 1] int64: tree ranges
    stage_thr: np.ndarray              # [S] float32

    @property
    def n_stages(self) -> int:
        return len(self.stage_thr)

    @property
    def has_tilted(self) -> bool:
        return bool(self.tilted.any())


def load_cascade(path: str) -> Cascade:
    """Parse an OpenCV cascade XML file (``<cascade>``, HAAR, trees of
    depth at most 2)."""
    casc = ET.parse(path).getroot().find("cascade")
    if casc is None or casc.find("featureType").text.strip() != "HAAR":
        raise ValueError(f"{path}: not a new-format HAAR cascade")
    window = (int(casc.find("width").text), int(casc.find("height").text))
    feats = list(casc.find("features"))
    rects = np.zeros((len(feats), 3, 4), np.int64)
    weights = np.zeros((len(feats), 3), np.float32)
    tilted = np.zeros(len(feats), bool)
    for f, el in enumerate(feats):
        for r, rect in enumerate(el.find("rects")):
            vals = rect.text.split()
            rects[f, r] = [int(v) for v in vals[:4]]
            weights[f, r] = np.float32(vals[4])
        t = el.find("tilted")
        tilted[f] = t is not None and t.text.strip() == "1"

    tree_feat, tree_thr, tree_leaf = [], [], []
    stage_first, stage_thr = [0], []
    for stage in casc.find("stages"):
        stage_thr.append(np.float32(stage.find("stageThreshold").text))
        for weak in stage.find("weakClassifiers"):
            raw = weak.find("internalNodes").text.split()
            leaves = [np.float32(v) for v in weak.find("leafValues").text.split()]
            nodes = [(int(raw[k]), int(raw[k + 1]), int(raw[k + 2]),
                      np.float32(raw[k + 3])) for k in range(0, len(raw), 4)]

            def child(idx, root_feat):
                if idx <= 0:
                    v = leaves[-idx]
                    return root_feat, np.float32(np.inf), v, v
                left, right, f, t = nodes[idx]
                if left > 0 or right > 0:
                    raise ValueError(f"{path}: a tree deeper than 2")
                return f, t, leaves[-left], leaves[-right]

            left, right, f0, t0 = nodes[0]
            fl, tl, la, lb = child(left, f0)
            fr, tr, ra, rb = child(right, f0)
            tree_feat.append((f0, fl, fr))
            tree_thr.append((t0, tl, tr))
            tree_leaf.append((la, lb, ra, rb))
        stage_first.append(len(tree_feat))
    return Cascade(window, rects, weights, tilted,
                   np.asarray(tree_feat, np.int64),
                   np.asarray(tree_thr, np.float32),
                   np.asarray(tree_leaf, np.float32),
                   np.asarray(stage_first, np.int64),
                   np.asarray(stage_thr, np.float32))


# ----------------------------------------------------------------- pyramid
@dataclasses.dataclass(frozen=True)
class Level:
    factor: float
    sw: int
    sh: int
    step: int
    nx: int
    ny: int
    out_w: int
    out_h: int


def levels(img_w: int, img_h: int, window: tuple[int, int], factor: float,
           min_size=(0, 0), max_size=(0, 0)) -> list[Level]:
    """detectMultiScale's scale loop."""
    max_w = max_size[0] or img_w
    max_h = max_size[1] or img_h
    out, f = [], 1.0
    while True:
        ww, wh = int(np.rint(window[0] * f)), int(np.rint(window[1] * f))
        if ww > max_w or wh > max_h or ww > img_w or wh > img_h:
            return out
        if ww >= min_size[0] and wh >= min_size[1]:
            sw, sh = int(np.rint(img_w / f)), int(np.rint(img_h / f))
            step = 1 if f > 2.0 else 2
            gx, gy = sw - window[0] + 1, sh - window[1] + 1
            if gx > 0 and gy > 0:
                out.append(Level(f, sw, sh, step, -(-gx // step),
                                 -(-gy // step), ww, wh))
        f *= factor


# ---------------------------------------------------------- preprocessing
def _exact_taps(src: int, dst: int):
    x = np.arange(dst, dtype=np.float64)
    fx = ((2 * x + 1) * src - dst) / (2 * dst)
    sx = np.floor(fx)
    frac = np.where(sx < 0, 0.0, fx - sx)
    i0 = np.clip(sx, 0, src - 1).astype(np.int64)
    i1 = np.clip(i0 + 1, 0, src - 1)
    w1 = np.rint(frac * 256).astype(np.int64)
    return i0, i1, 256 - w1, w1


def resize_exact(img: torch.Tensor, dw: int, dh: int) -> torch.Tensor:
    """[B, H, W] uint8 → [B, dh, dw] uint8, cv::resize INTER_LINEAR_EXACT:
    Q8 taps each way, the Q16 sum rounded half up and clipped."""
    sh, sw = img.shape[-2:]
    if (sw, sh) == (dw, dh):
        return img
    dev = img.device
    x0, x1, cx0, cx1 = (torch.from_numpy(a).to(dev)
                        for a in _exact_taps(sw, dw))
    y0, y1, cy0, cy1 = (torch.from_numpy(a).to(dev)
                        for a in _exact_taps(sh, dh))
    im = img.to(torch.int64)
    h = im[..., x0] * cx0 + im[..., x1] * cx1
    v = h[..., y0, :] * cy0[:, None] + h[..., y1, :] * cy1[:, None]
    return ((v + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8)


def equalize(img: torch.Tensor) -> torch.Tensor:
    """[B, H, W] uint8 → cv::equalizeHist of each frame."""
    B, H, W = img.shape
    flat = img.reshape(B, -1).to(torch.int64)
    hist = torch.zeros((B, 256), dtype=torch.int64, device=img.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    bins = torch.arange(256, device=img.device)
    i0 = torch.where(hist > 0, bins, 256).amin(1)
    h0 = hist.gather(1, i0[:, None])[:, 0]
    total = H * W
    scale = (torch.tensor(255.0, dtype=torch.float32, device=img.device)
             / (total - h0).clamp(min=1).to(torch.float32))
    run = torch.cumsum(hist, 1) - torch.cumsum(hist, 1).gather(1, i0[:, None])
    lut = torch.round(run.to(torch.float32) * scale[:, None]).clamp(0, 255)
    lut = torch.where(bins[None] <= i0[:, None], 0.0, lut).to(torch.uint8)
    out = lut.gather(1, flat).reshape(B, H, W)
    return torch.where((h0 == total)[:, None, None], img, out)


def gray_from_bgr(bgr: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 BGR → Y, cv::cvtColor(COLOR_BGR2GRAY) for 8-bit
    input in OpenCV 4's fixed point: (B*3735 + G*19235 + R*9798 + 2^14)
    >> 15."""
    x = bgr.to(torch.int64)
    y = x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798
    return ((y + (1 << 14)) >> 15).to(torch.uint8)


# ------------------------------------------------------------------ tables
def _integral(x: torch.Tensor) -> torch.Tensor:
    s = torch.cumsum(torch.cumsum(x, -1), -2)
    return torch.nn.functional.pad(s, (1, 0, 1, 0))


def tilted_integral(img: torch.Tensor) -> torch.Tensor:
    """[B, H, W] → [B, H+1, W+1] int64, cv::integral's tilted table:
    T(y, x) = sum of img[y', x'] over y' < y and |x' - (x-1)| <= y-y'-1.

    Row y' adds to T(y, x) the segment [x-y+y', x+y-y'-2] of its pixels,
    a difference of its exclusive prefix sums P: P[y', x+y-1-y'] -
    P[y', x-y+y'] (indices clamped to [0, W]). Both terms are sums along
    diagonals, kept as running sums A (over k = x+y-1) and D (over
    m = x-y+H) while y grows."""
    B, H, W = img.shape
    dev = img.device
    P = torch.nn.functional.pad(torch.cumsum(img.to(torch.int64), -1),
                                (1, 0))                     # [B, H, W+1]
    k = torch.arange(W + H, device=dev)
    A = torch.zeros((B, W + H), dtype=torch.int64, device=dev)
    D = torch.zeros((B, W + H), dtype=torch.int64, device=dev)
    T = torch.zeros((B, H + 1, W + 1), dtype=torch.int64, device=dev)
    xs = torch.arange(W + 1, device=dev)
    for y in range(1, H + 1):
        r = y - 1                                           # row y' = y-1
        A += P[:, r].gather(1, (k - r).clamp(0, W).expand(B, -1))
        D += P[:, r].gather(1, (k - H + r).clamp(0, W).expand(B, -1))
        T[:, y] = (A.gather(1, (xs + y - 1).expand(B, -1))
                   - D.gather(1, (xs - y + H).expand(B, -1)))
    return T


# -------------------------------------------------------------- evaluation
def _corners(rect, tilted: bool):
    x, y, w, h = (int(v) for v in rect)
    if tilted:
        return [(y, x, 1), (y + w, x + w, -1), (y + h, x - h, -1),
                (y + w + h, x + w - h, 1)]
    return [(y, x, 1), (y, x + w, -1), (y + h, x, -1), (y + h, x + w, 1)]


class Detector:
    """detectMultiScale for one cascade at one image size, on `device`.
    ``prec`` is the dtype of a feature's product with vnf and of its
    comparison: float32 as OpenCV, bfloat16 for the control."""

    CHUNK = 1 << 22        # table reads gathered at once

    def __init__(self, cascade: Cascade, size: tuple[int, int],
                 factor: float, min_size=(0, 0),
                 device: str | torch.device = "cpu",
                 prec: torch.dtype = torch.float32):
        self.c = cascade
        self.size = size
        self.device = torch.device(device)
        self.prec = prec
        self.levels = levels(size[0], size[1], cascade.window, factor,
                             min_size)
        ww, wh = cascade.window
        self.norm_area = float((ww - 2) * (wh - 2))
        self.norm = [(1, 1, 1), (1, ww - 1, -1), (wh - 1, 1, -1),
                     (wh - 1, ww - 1, 1)]
        dev = self.device
        # per stage: the distinct features its nodes read, and each tree
        # node's column among them
        self.stages = []
        for s in range(cascade.n_stages):
            t0, t1 = cascade.stage_first[s], cascade.stage_first[s + 1]
            tf = cascade.tree_feat[t0:t1]
            used, col = np.unique(tf, return_inverse=True)
            self.stages.append(dict(
                used=used, col=torch.from_numpy(col.reshape(-1, 3)).to(dev),
                thr=torch.from_numpy(cascade.tree_thr[t0:t1]).to(dev),
                leaf=torch.from_numpy(cascade.tree_leaf[t0:t1]).to(dev),
                stage_thr=float(cascade.stage_thr[s])))

    def _feature_reads(self, used, pitch, plane):
        """Per used feature, its rects' 4 corner offsets (into the sum
        plane, or the tilted plane at `plane`), signs and weights."""
        c = self.c
        off = np.zeros((len(used), 3, 4), np.int64)
        sgn = np.zeros((len(used), 3, 4), np.int64)
        for i, f in enumerate(used):
            base = plane if c.tilted[f] else 0
            for r in range(3):
                if c.weights[f, r] == 0:
                    continue
                for j, (dy, dx, s) in enumerate(_corners(c.rects[f, r],
                                                         c.tilted[f])):
                    off[i, r, j] = base + dy * pitch + dx
                    sgn[i, r, j] = s
        dev = self.device
        return (torch.from_numpy(off).to(dev), torch.from_numpy(sgn).to(dev),
                torch.from_numpy(self.c.weights[used]).to(dev))

    def _stage_pass(self, st, reads, tab, org, vnf):
        """Windows at origins `org` → bool [N] passing stage `st`."""
        off, sgn, wgt = reads
        n_read = off.shape[0] * 12
        out = []
        for i in range(0, org.shape[0], max(1, self.CHUNK // n_read)):
            o = org[i:i + self.CHUNK // n_read]
            v = tab[o[:, None, None, None] + off[None]]       # [n, U, 3, 4]
            rs = (v * sgn[None]).sum(-1).to(torch.float32)   # rect sums
            feat = rs[..., 0] * wgt[:, 0]
            feat = feat + rs[..., 1] * wgt[:, 1]
            feat = feat + rs[..., 2] * wgt[:, 2]
            val = (feat.to(self.prec)
                   * vnf[i:i + o.shape[0], None].to(self.prec))
            node = val[:, st["col"]]                         # [n, T, 3]
            thr = st["thr"].to(self.prec)
            leaf = st["leaf"]
            go_l = node[..., 1] < thr[:, 1]
            go_r = node[..., 2] < thr[:, 2]
            lv = torch.where(go_l, leaf[:, 0], leaf[:, 1])
            rv = torch.where(go_r, leaf[:, 2], leaf[:, 3])
            tree = torch.where(node[..., 0] < thr[:, 0], lv, rv).to(self.prec)
            total = torch.zeros_like(tree[:, 0])
            for t in range(tree.shape[1]):          # in the trees' order
                total = total + tree[:, t]
            out.append(total >= torch.tensor(st["stage_thr"]).to(self.prec))
        return torch.cat(out) if out else org.new_zeros(0, dtype=torch.bool)

    def _level(self, gray: torch.Tensor, l: Level, n_stages: int | None):
        """One level → (frame, window index) of the windows that pass the
        first `n_stages` stages (all by default), and the count of windows
        that leave at each stage (index n_stages: passed; -1 slot: the
        variance test)."""
        B = gray.shape[0]
        img = resize_exact(gray, l.sw, l.sh)
        x64 = img.to(torch.int64)
        ii, sq = _integral(x64), _integral(x64 * x64)
        pitch, rows = l.sw + 1, l.sh + 1
        plane = B * rows * pitch
        tab = ii.reshape(-1)
        if self.c.has_tilted:
            tab = torch.cat([tab, tilted_integral(img).reshape(-1)])
        dev = gray.device
        iy = torch.arange(l.ny, device=dev) * l.step
        ix = torch.arange(l.nx, device=dev) * l.step
        org = ((torch.arange(B, device=dev)[:, None, None] * rows * pitch
                + iy[None, :, None] * pitch + ix[None, None, :]).reshape(-1))
        wid = torch.arange(org.shape[0], device=dev)

        def rect(t, corners):
            acc = 0
            for dy, dx, s in corners:
                acc = acc + s * t.reshape(-1)[org + dy * pitch + dx]
            return acc

        vsum = rect(ii, self.norm).to(torch.float32)
        vsq = rect(sq, self.norm).to(torch.float32)
        nf = self.norm_area * vsq - vsum * vsum
        ok = nf > 100.0 * self.norm_area * self.norm_area
        root = torch.sqrt(nf.clamp(min=1e-20).to(torch.float64)).to(
            torch.float32)
        vnf = torch.where(ok, 1.0 / root, torch.ones_like(root))
        n_s = self.c.n_stages if n_stages is None else n_stages
        leave = [int((~ok).sum())]
        org, wid, vnf = org[ok], wid[ok], vnf[ok]
        for s in range(n_s):
            st = self.stages[s]
            if org.shape[0] == 0:
                leave.append(0)
                continue
            reads = self._feature_reads(st["used"], pitch, plane)
            p = self._stage_pass(st, reads, tab, org, vnf)
            leave.append(int((~p).sum()))
            org, wid, vnf = org[p], wid[p], vnf[p]
        leave.append(int(org.shape[0]))
        nwin = l.nx * l.ny
        return wid // nwin, wid % nwin, leave

    def candidates(self, gray: torch.Tensor) -> list[np.ndarray]:
        """[B, H, W] uint8 work images → per frame the accepted windows
        [N, 4] (x, y, w, h), level by level, each level in raster order."""
        gray = gray.to(self.device)
        B = gray.shape[0]
        per = [[] for _ in range(B)]
        for l in self.levels:
            b, w, _ = self._level(gray, l, None)
            b, w = b.cpu().numpy(), w.cpu().numpy()
            x = np.rint((w % l.nx) * l.step * l.factor).astype(np.int64)
            y = np.rint((w // l.nx) * l.step * l.factor).astype(np.int64)
            box = np.stack([x, y, np.full_like(x, l.out_w),
                            np.full_like(x, l.out_h)], 1)
            for f in range(B):
                per[f].append(box[b == f])
        return [np.concatenate(p) if p else np.zeros((0, 4), np.int64)
                for p in per]

    def stage_exits(self, gray: torch.Tensor, n_stages: int) -> list[list]:
        """Per level, the windows of all frames leaving at the variance
        test, at each of the first `n_stages` stages, and passing them."""
        gray = gray.to(self.device)
        return [self._level(gray, l, n_stages)[2] for l in self.levels]


# ---------------------------------------------------------------- grouping
def group_rectangles(rects: np.ndarray, min_neighbors: int,
                     eps: float = 0.2) -> np.ndarray:
    """cv::groupRectangles(rects, min_neighbors, eps) → [M, 4] int64."""
    rects = np.asarray(rects, np.int64).reshape(-1, 4)
    n = len(rects)
    if n == 0:
        return np.zeros((0, 4), np.int64)
    x, y, w, h = rects.T
    delta = eps * (np.minimum(w[:, None], w[None]) +
                   np.minimum(h[:, None], h[None])) * 0.5
    sim = ((np.abs(x[:, None] - x[None]) <= delta)
           & (np.abs(y[:, None] - y[None]) <= delta)
           & (np.abs((x + w)[:, None] - (x + w)[None]) <= delta)
           & (np.abs((y + h)[:, None] - (y + h)[None]) <= delta))
    # classes: connected components, numbered by their first member
    label = np.full(n, -1)
    n_cls = 0
    for i in range(n):
        if label[i] >= 0:
            continue
        todo = [i]
        label[i] = n_cls
        while todo:
            j = todo.pop()
            for k in np.nonzero(sim[j] & (label < 0))[0]:
                label[k] = n_cls
                todo.append(k)
        n_cls += 1
    count = np.bincount(label, minlength=n_cls)
    sums = np.zeros((n_cls, 4), np.int64)
    np.add.at(sums, label, rects)
    avg = np.rint(sums / count[:, None]).astype(np.int64)
    keep = []
    for i in range(n_cls):
        if count[i] <= min_neighbors:
            continue
        r1, n1 = avg[i], count[i]
        inside = False
        for j in range(n_cls):
            if j == i or count[j] <= min_neighbors:
                continue
            r2, n2 = avg[j], count[j]
            dx, dy = int(np.rint(r2[2] * eps)), int(np.rint(r2[3] * eps))
            if (r1[0] >= r2[0] - dx and r1[1] >= r2[1] - dy
                    and r1[0] + r1[2] <= r2[0] + r2[2] + dx
                    and r1[1] + r1[3] <= r2[1] + r2[3] + dy
                    and (n2 > max(3, n1) or n1 < 3)):
                inside = True
                break
        if not inside:
            keep.append(i)
    return avg[keep]
