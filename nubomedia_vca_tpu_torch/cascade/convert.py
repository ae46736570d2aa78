"""Convert OpenCV Haar-cascade XML between the old (1.x/2.x
``opencv-haar-classifier``) and new (≥2.4 ``<cascade>``) formats.

The reference deployment loads old-format mcs cascades from hard-coded
paths (``kmseyedetect.cpp:28-29``, ``kmsnosedetect.cpp:32``,
``kmseardetect.cpp:30-31``, ``kmsmouthdetect.cpp:38``); modern OpenCV (≥4)
cannot read those files. ``old_to_new_xml`` lets a user of this framework
(or of stock OpenCV) convert them once offline. ``new_to_old_xml`` is the
inverse, used by the round-trip loader tests.

Both directions go through the flat ``HaarCascade`` arrays, which encode
both formats' shared semantics exactly (see ``xml_loader`` docstring), so
``load(convert(x)) == load(x)`` array-for-array.

A copy of ``nubomedia_vca_tpu/cascade/convert.py`` over the port's
``xml_loader``; its XML output is byte-identical to the JAX package's.

CLI:  python -m nubomedia_vca_tpu_torch.cascade.convert in.xml out.xml [--to-old]
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from .xml_loader import HaarCascade, load_cascade_xml


def _fmt(v: float) -> str:
    """OpenCV-style float formatting (repr keeps full f32 precision)."""
    return repr(float(np.float32(v)))


def _feature_el(parent, casc: HaarCascade, fi: int):
    feat = ET.SubElement(parent, "feature")
    rects = ET.SubElement(feat, "rects")
    for j in range(casc.rects.shape[1]):
        x, y, w, h = (int(v) for v in casc.rects[fi, j])
        wt = float(casc.rect_weights[fi, j])
        if w == 0 and h == 0 and wt == 0.0:
            continue  # padding
        ET.SubElement(rects, "_").text = f"{x} {y} {w} {h} {_fmt(wt)}"
    ET.SubElement(feat, "tilted").text = "1" if casc.tilted[fi] else "0"


def _weak_children(casc: HaarCascade, w: int):
    """Decode the padded depth-2 weak ``w`` back into (left, right) where
    each side is ('val', v) or ('node', (feat, thr, leaf0, leaf1))."""
    out = []
    for feat, thr, leaves in (
        (casc.featL[w], casc.thrL[w], casc.leavesL[w]),
        (casc.featR[w], casc.thrR[w], casc.leavesR[w]),
    ):
        if np.isinf(thr):
            out.append(("val", float(leaves[0])))
        else:
            out.append(("node", (int(feat), float(thr),
                                 float(leaves[0]), float(leaves[1]))))
    return out


def cascade_to_old_xml(casc: HaarCascade, name: str = "cascade") -> ET.ElementTree:
    root = ET.Element("opencv_storage")
    top = ET.SubElement(root, name, {"type_id": "opencv-haar-classifier"})
    ET.SubElement(top, "size").text = f"{casc.window_w} {casc.window_h}"
    stages_el = ET.SubElement(top, "stages")
    for s in range(casc.n_stages):
        st = ET.SubElement(stages_el, "_")
        trees = ET.SubElement(st, "trees")
        for w in np.nonzero(casc.weak_stage == s)[0]:
            tree = ET.SubElement(trees, "_")
            sides = _weak_children(casc, int(w))
            node_idx = 1
            root_el = ET.SubElement(tree, "_")
            _feature_el(root_el, casc, int(casc.feat0[w]))
            ET.SubElement(root_el, "threshold").text = _fmt(casc.thr0[w])
            pending = []
            for side, (kind, payload) in zip(("left", "right"), sides):
                if kind == "val":
                    ET.SubElement(root_el, f"{side}_val").text = _fmt(payload)
                else:
                    ET.SubElement(root_el, f"{side}_node").text = str(node_idx)
                    pending.append(payload)
                    node_idx += 1
            for feat, thr, l0, l1 in pending:
                nd = ET.SubElement(tree, "_")
                _feature_el(nd, casc, feat)
                ET.SubElement(nd, "threshold").text = _fmt(thr)
                ET.SubElement(nd, "left_val").text = _fmt(l0)
                ET.SubElement(nd, "right_val").text = _fmt(l1)
        ET.SubElement(st, "stage_threshold").text = _fmt(
            casc.stage_thresholds[s])
        ET.SubElement(st, "parent").text = str(s - 1)
        ET.SubElement(st, "next").text = "-1"
    return ET.ElementTree(root)


def cascade_to_new_xml(casc: HaarCascade) -> ET.ElementTree:
    root = ET.Element("opencv_storage")
    top = ET.SubElement(root, "cascade", {"type_id": "opencv-cascade-classifier"})
    ET.SubElement(top, "stageType").text = "BOOST"
    ET.SubElement(top, "featureType").text = "HAAR"
    ET.SubElement(top, "height").text = str(casc.window_h)
    ET.SubElement(top, "width").text = str(casc.window_w)
    sp = ET.SubElement(top, "stageParams")
    ET.SubElement(sp, "maxWeakCount").text = str(
        int(casc.stage_weak_counts().max()))
    fp = ET.SubElement(top, "featureParams")
    ET.SubElement(fp, "maxCatCount").text = "0"
    ET.SubElement(top, "stageNum").text = str(casc.n_stages)

    stages_el = ET.SubElement(top, "stages")
    for s in range(casc.n_stages):
        st = ET.SubElement(stages_el, "_")
        weak_ids = np.nonzero(casc.weak_stage == s)[0]
        ET.SubElement(st, "maxWeakCount").text = str(len(weak_ids))
        ET.SubElement(st, "stageThreshold").text = _fmt(
            casc.stage_thresholds[s])
        weaks_el = ET.SubElement(st, "weakClassifiers")
        for w in weak_ids:
            wk = ET.SubElement(weaks_el, "_")
            nodes = [(int(casc.feat0[w]), float(casc.thr0[w]))]
            children, leaves = [], []

            def leaf(v: float) -> int:
                leaves.append(v)
                return -(len(leaves) - 1)

            root_children = []
            for kind, payload in _weak_children(casc, int(w)):
                if kind == "val":
                    root_children.append(leaf(payload))
                else:
                    feat, thr, l0, l1 = payload
                    nodes.append((feat, thr))
                    idx = len(nodes) - 1
                    children.append((idx, leaf(l0), leaf(l1)))
                    root_children.append(idx)
            internal = [f"{root_children[0]} {root_children[1]} "
                        f"{nodes[0][0]} {_fmt(nodes[0][1])}"]
            for idx, l0, l1 in children:
                internal.append(
                    f"{l0} {l1} {nodes[idx][0]} {_fmt(nodes[idx][1])}")
            ET.SubElement(wk, "internalNodes").text = " ".join(internal)
            ET.SubElement(wk, "leafValues").text = " ".join(
                _fmt(v) for v in leaves)

    feats_el = ET.SubElement(top, "features")
    for fi in range(casc.n_features):
        fe = ET.SubElement(feats_el, "_")
        rects = ET.SubElement(fe, "rects")
        for j in range(casc.rects.shape[1]):
            x, y, w, h = (int(v) for v in casc.rects[fi, j])
            wt = float(casc.rect_weights[fi, j])
            if w == 0 and h == 0 and wt == 0.0:
                continue
            ET.SubElement(rects, "_").text = f"{x} {y} {w} {h} {_fmt(wt)}"
        if casc.tilted[fi]:
            ET.SubElement(fe, "tilted").text = "1"
    return ET.ElementTree(root)


def old_to_new_xml(in_path: str, out_path: str) -> None:
    tree = cascade_to_new_xml(load_cascade_xml(in_path))
    ET.indent(tree)
    tree.write(out_path, xml_declaration=True, encoding="unicode")


def new_to_old_xml(in_path: str, out_path: str) -> None:
    name = os.path.splitext(os.path.basename(in_path))[0].replace("-", "_")
    tree = cascade_to_old_xml(load_cascade_xml(in_path), name)
    ET.indent(tree)
    tree.write(out_path, xml_declaration=True, encoding="unicode")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--to-old", action="store_true",
                    help="convert new→old instead of the default old→new")
    ns = ap.parse_args(argv)
    (new_to_old_xml if ns.to_old else old_to_new_xml)(ns.input, ns.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
