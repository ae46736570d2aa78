"""OpenCV cascade-XML → flat numpy arrays.

A copy of ``nubomedia_vca_tpu/cascade/xml_loader.py`` (pure numpy, so the
PyTorch port carries it without importing the JAX package), plus
``cascade_from_numpy``.

Parses BOTH OpenCV cascade XML formats into dense tensors suitable for
vectorized device evaluation:

* new format (OpenCV ≥2.4 ``<cascade>`` element) — e.g.
  ``haarcascade_frontalface_alt.xml`` loaded by the reference's
  ``CascadeClassifier::load`` (``kmsfacedetect.cpp:162-177``);
* old format (OpenCV 1.x/2.x ``type_id="opencv-haar-classifier"``) — the
  reference's mcs part cascades are this format:
  ``haarcascade_mcs_{left,right}eye.xml`` (``kmseyedetect.cpp:28-29``),
  ``haarcascade_mcs_mouth.xml`` (``kmsmouthdetect.cpp:38``),
  ``haarcascade_mcs_nose.xml`` (``kmsnosedetect.cpp:32``),
  ``haarcascade_mcs_{left,right}ear.xml`` (``kmseardetect.cpp:30-31``).

The two formats encode the SAME evaluation semantics (same rect weights,
node thresholds, and leaf values; OpenCV's old C path folds the
window-area normalization into scaled hidden weights and the new path into
``varianceNormFactor`` — algebraically identical), so both parse into one
``HaarCascade``. ``cascade/convert.py`` converts files between the formats.

Weak classifiers are boosted decision trees of depth ≤ 2 in every cascade the
reference uses (stumps for face/profile/smile, 2-split trees for the eye
cascades).  Each weak is normalized here to a *uniform padded depth-2 tree*:

        root: (feat0, thr0)
       /                    \
  left: (featL, thrL)    right: (featR, thrR)
   leaves [ll0, ll1]      leaves [rl0, rl1]

A child that is a leaf in the XML is padded to a node with ``thr=+inf`` and
both leaves equal to the leaf value, so evaluation is branch-free:

    out = where(v0 < thr0, where(vL < thrL, ll0, ll1),
                           where(vR < thrR, rl0, rl1))

This costs at most 3 feature lookups per weak but removes all data-dependent
control flow (SURVEY.md §7 "hard parts").
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np

MAX_RECTS = 3  # every OpenCV Haar feature has 2 or 3 weighted rects


@dataclasses.dataclass
class HaarCascade:
    """Flat-array form of one cascade. All arrays are host numpy."""

    name: str
    window_w: int
    window_h: int
    # features ------------------------------------------------------------
    rects: np.ndarray        # int32  [F, MAX_RECTS, 4]  (x, y, w, h); zero-padded
    rect_weights: np.ndarray  # float32 [F, MAX_RECTS]; 0 for padding
    tilted: np.ndarray       # bool   [F]
    # weak trees (uniform padded depth-2) ---------------------------------
    feat0: np.ndarray        # int32  [W]
    thr0: np.ndarray         # float32 [W]
    featL: np.ndarray        # int32  [W]
    thrL: np.ndarray         # float32 [W] (+inf when left child is a leaf)
    leavesL: np.ndarray      # float32 [W, 2]
    featR: np.ndarray        # int32  [W]
    thrR: np.ndarray         # float32 [W]
    leavesR: np.ndarray      # float32 [W, 2]
    # stages --------------------------------------------------------------
    weak_stage: np.ndarray   # int32  [W] stage index of each weak
    stage_thresholds: np.ndarray  # float32 [S]

    @property
    def n_features(self) -> int:
        return int(self.rects.shape[0])

    @property
    def n_weaks(self) -> int:
        return int(self.feat0.shape[0])

    @property
    def n_stages(self) -> int:
        return int(self.stage_thresholds.shape[0])

    @property
    def has_tilted(self) -> bool:
        return bool(self.tilted.any())

    def stage_weak_counts(self) -> np.ndarray:
        return np.bincount(self.weak_stage, minlength=self.n_stages)


def _load_old_format(path: str, casc) -> HaarCascade:
    """Old-format (OpenCV 1.x/2.x) parser.

    Structure: ``<size>w h</size>`` then ``<stages>`` of ``<trees>`` of node
    lists; each node carries its own ``<feature>`` (rects+tilted), a
    ``<threshold>``, and per side either ``<left_val>``/``<right_val>``
    (leaf) or ``<left_node>``/``<right_node>`` (index into the tree's node
    list). Features get appended to a flat table (the old format has no
    shared feature table); trees are normalized to the same padded depth-2
    form as the new-format parser (see module docstring).
    """
    size = casc.find("size").text.split()
    window_w, window_h = int(size[0]), int(size[1])

    rects_l: list[np.ndarray] = []
    weights_l: list[np.ndarray] = []
    tilted_l: list[bool] = []

    def add_feature(feat_el) -> int:
        rs, tl = _parse_feature(feat_el)
        if len(rs) > MAX_RECTS:
            raise ValueError(f"{path}: feature has {len(rs)} rects")
        r = np.zeros((MAX_RECTS, 4), np.int32)
        w = np.zeros(MAX_RECTS, np.float32)
        for j, (x, y, ww, hh, wt) in enumerate(rs):
            r[j] = (x, y, ww, hh)
            w[j] = wt
        rects_l.append(r)
        weights_l.append(w)
        tilted_l.append(tl)
        return len(rects_l) - 1

    feat0, thr0 = [], []
    featL, thrL, leavesL = [], [], []
    featR, thrR, leavesR = [], [], []
    weak_stage, stage_thresholds = [], []

    INF = np.float32(np.inf)

    def node_side(node_el, side: str):
        """Returns ('val', v) or ('node', idx) for one child of a node."""
        v = node_el.find(f"{side}_val")
        if v is not None:
            return ("val", np.float32(v.text))
        return ("node", int(node_el.find(f"{side}_node").text))

    def child_arrays(nodes, kind, ref):
        """(feat, thr, leaf0, leaf1) for a child; pads leaves to a node."""
        if kind == "val":
            return 0, INF, ref, ref
        cfeat, cthr, cl, cr = nodes[ref]
        if cl[0] != "val" or cr[0] != "val":
            raise ValueError(f"{path}: weak tree deeper than 2 — unsupported")
        return cfeat, cthr, cl[1], cr[1]

    for s_idx, stage in enumerate(casc.find("stages")):
        stage_thresholds.append(float(stage.find("stage_threshold").text))
        parent = stage.find("parent")
        nxt = stage.find("next")
        if ((parent is not None and int(parent.text) not in (s_idx - 1, -1))
                or (nxt is not None and int(nxt.text) != -1)):
            raise ValueError(
                f"{path}: tree-structured cascade (non-linear stages) "
                "unsupported")
        for tree in stage.find("trees"):
            # each tree is a sequence of <_> node elements; node 0 is root
            nodes = []
            for node_el in tree:
                fidx = add_feature(node_el.find("feature"))
                nodes.append((
                    fidx,
                    np.float32(node_el.find("threshold").text),
                    node_side(node_el, "left"),
                    node_side(node_el, "right"),
                ))
            rfeat, rthr, rl, rr = nodes[0]
            fL, tL, ll0, ll1 = child_arrays(nodes, rl[0], rl[1])
            fR, tR, rl0, rl1 = child_arrays(nodes, rr[0], rr[1])
            feat0.append(rfeat)
            thr0.append(rthr)
            featL.append(fL); thrL.append(tL); leavesL.append((ll0, ll1))
            featR.append(fR); thrR.append(tR); leavesR.append((rl0, rl1))
            weak_stage.append(s_idx)

    return HaarCascade(
        name=path,
        window_w=window_w,
        window_h=window_h,
        rects=np.stack(rects_l).astype(np.int32),
        rect_weights=np.stack(weights_l).astype(np.float32),
        tilted=np.asarray(tilted_l, bool),
        feat0=np.asarray(feat0, np.int32),
        thr0=np.asarray(thr0, np.float32),
        featL=np.asarray(featL, np.int32),
        thrL=np.asarray(thrL, np.float32),
        leavesL=np.asarray(leavesL, np.float32),
        featR=np.asarray(featR, np.int32),
        thrR=np.asarray(thrR, np.float32),
        leavesR=np.asarray(leavesR, np.float32),
        weak_stage=np.asarray(weak_stage, np.int32),
        stage_thresholds=np.asarray(stage_thresholds, np.float32),
    )


def _parse_feature(feat_el) -> tuple[list[tuple[int, int, int, int, float]], bool]:
    rects = []
    for r in feat_el.find("rects"):
        vals = r.text.split()
        x, y, w, h = (int(v) for v in vals[:4])
        weight = float(vals[4])
        rects.append((x, y, w, h, weight))
    tilted_el = feat_el.find("tilted")
    tilted = tilted_el is not None and tilted_el.text.strip() == "1"
    return rects, tilted


def load_cascade_xml(path: str) -> HaarCascade:
    """Load either cascade XML format (dispatch on the root child)."""
    root = ET.parse(path).getroot()
    casc = root[0]
    if casc.get("type_id") == "opencv-haar-classifier":
        return _load_old_format(path, casc)
    if casc.tag != "cascade":
        raise ValueError(
            f"{path}: neither a new-format <cascade> nor an old-format "
            "opencv-haar-classifier document"
        )
    feature_type = casc.find("featureType").text.strip()
    if feature_type != "HAAR":
        raise ValueError(f"{path}: featureType {feature_type!r} != HAAR")

    window_w = int(casc.find("width").text)
    window_h = int(casc.find("height").text)

    feats = casc.find("features")
    F = len(feats)
    rects = np.zeros((F, MAX_RECTS, 4), np.int32)
    rect_weights = np.zeros((F, MAX_RECTS), np.float32)
    tilted = np.zeros(F, bool)
    for i, fe in enumerate(feats):
        rs, tl = _parse_feature(fe)
        if len(rs) > MAX_RECTS:
            raise ValueError(f"{path}: feature {i} has {len(rs)} rects")
        for j, (x, y, w, h, wt) in enumerate(rs):
            rects[i, j] = (x, y, w, h)
            rect_weights[i, j] = wt
        tilted[i] = tl

    feat0, thr0 = [], []
    featL, thrL, leavesL = [], [], []
    featR, thrR, leavesR = [], [], []
    weak_stage, stage_thresholds = [], []

    INF = np.float32(np.inf)

    def _child(nodes, leaves, idx):
        """Resolve child encoded as OpenCV node/leaf index.

        idx > 0  → internal node at ``nodes[idx]`` (must itself have 2 leaves)
        idx <= 0 → leaf value ``leaves[-idx]``
        Returns (feat, thr, leaf0, leaf1).
        """
        if idx <= 0:
            v = leaves[-idx]
            return 0, INF, v, v  # always takes leaf0 == leaf1 == v
        left, right, f, t = nodes[idx]
        if left > 0 or right > 0:
            raise ValueError("weak tree deeper than 2 — unsupported")
        return f, np.float32(t), leaves[-left], leaves[-right]

    for s_idx, stage in enumerate(casc.find("stages")):
        stage_thresholds.append(float(stage.find("stageThreshold").text))
        for weak in stage.find("weakClassifiers"):
            raw = weak.find("internalNodes").text.split()
            leaves = [np.float32(v) for v in weak.find("leafValues").text.split()]
            nodes = []
            for k in range(0, len(raw), 4):
                nodes.append(
                    (int(raw[k]), int(raw[k + 1]), int(raw[k + 2]),
                     float(raw[k + 3]))
                )
            rl, rr, rf, rt = nodes[0]
            fL, tL, ll0, ll1 = _child(nodes, leaves, rl)
            fR, tR, rl0, rl1 = _child(nodes, leaves, rr)
            feat0.append(rf)
            thr0.append(np.float32(rt))
            featL.append(fL); thrL.append(tL); leavesL.append((ll0, ll1))
            featR.append(fR); thrR.append(tR); leavesR.append((rl0, rl1))
            weak_stage.append(s_idx)

    return HaarCascade(
        name=path,
        window_w=window_w,
        window_h=window_h,
        rects=rects,
        rect_weights=rect_weights,
        tilted=tilted,
        feat0=np.asarray(feat0, np.int32),
        thr0=np.asarray(thr0, np.float32),
        featL=np.asarray(featL, np.int32),
        thrL=np.asarray(thrL, np.float32),
        leavesL=np.asarray(leavesL, np.float32),
        featR=np.asarray(featR, np.int32),
        thrR=np.asarray(thrR, np.float32),
        leavesR=np.asarray(leavesR, np.float32),
        weak_stage=np.asarray(weak_stage, np.int32),
        stage_thresholds=np.asarray(stage_thresholds, np.float32),
    )


_FIELD_DTYPES = {
    "rects": np.int32, "rect_weights": np.float32, "tilted": bool,
    "feat0": np.int32, "thr0": np.float32,
    "featL": np.int32, "thrL": np.float32, "leavesL": np.float32,
    "featR": np.int32, "thrR": np.float32, "leavesR": np.float32,
    "weak_stage": np.int32, "stage_thresholds": np.float32,
}


def cascade_from_numpy(fields: dict) -> HaarCascade:
    """Build a HaarCascade from another loader's fields (e.g.
    ``dataclasses.asdict`` of the JAX package's HaarCascade): array fields
    become numpy arrays of this module's dtypes, scalars pass through."""
    names = {f.name for f in dataclasses.fields(HaarCascade)}
    if set(fields) != names:
        raise ValueError(f"cascade fields {sorted(fields)} != {sorted(names)}")
    kw = {k: (np.asarray(v, _FIELD_DTYPES[k]) if k in _FIELD_DTYPES else v)
          for k, v in fields.items()}
    kw["window_w"], kw["window_h"] = int(kw["window_w"]), int(kw["window_h"])
    return HaarCascade(**kw)
