"""The frozen yardstick: the roofline count against a hand count, the
pyramid against a hand count, and the import rules of the benchmark's
sources."""

from __future__ import annotations

import ast
import pathlib

import numpy as np

from vcabench.frozen import roofline
from vcabench.reference import cascade as C

BENCH = pathlib.Path(__file__).resolve().parents[1]


def tiny_cascade() -> C.Cascade:
    """Two stages: a stump on a 2-rect feature, then a tree whose root
    reads a 3-rect feature and whose left child the 2-rect one."""
    inf = np.inf
    return C.Cascade(
        window=(6, 6),
        rects=np.array([[[0, 0, 3, 6], [0, 0, 1, 6], [0, 0, 0, 0]],
                        [[0, 0, 6, 3], [0, 1, 6, 1], [2, 0, 2, 6]]]),
        weights=np.array([[-1, 2, 0], [-1, 2, 3]], np.float32),
        tilted=np.zeros(2, bool),
        tree_feat=np.array([[0, 0, 0], [1, 0, 1]]),
        tree_thr=np.array([[0.1, inf, inf], [0.2, 0.3, inf]], np.float32),
        tree_leaf=np.array([[-1, -1, 1, 1], [-1, 1, 2, 2]], np.float32),
        stage_first=np.array([0, 1, 2]),
        stage_thr=np.array([0.0, 0.5], np.float32))


def test_dense_count_equals_hand_count():
    c = tiny_cascade()
    assert roofline.dense_stages(c.stage_first) == 2
    # a node: 4 per rect, the rects' sum, x vnf, the comparison
    # stage 0: 1 + stump (2 rects: 11) + leaf add 1 = 13
    # stage 1: 1 + root (3 rects: 16) + left child (11) + 1 = 29
    assert roofline.stage_ops(c, 2) == [13, 29]
    exits = [[3, 5, 2, 1]]     # variance out, leave at 0, at 1, pass
    assert roofline.dense_ops(c, exits) == 12 * 11 + 8 * 13 + 3 * 29
    lv = [C.Level(1.0, 10, 8, 2, 3, 2, 6, 6)]
    assert roofline.dense_bytes(lv, 80, 2) == 2 * (80 + 5 * 6)
    t, which = roofline.bound_s(220, 323)
    assert which == "bytes" and t == 220 / 3.35e12


def test_levels_equal_hand_count():
    got = C.levels(40, 30, (20, 20), 1.25)
    assert [(l.sw, l.sh, l.step, l.nx, l.ny, l.out_w) for l in got] == [
        (40, 30, 2, 11, 6, 20), (32, 24, 2, 7, 3, 25)]


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        bad = _imports(path) & {"jax", "jaxlib", "flax", "nubomedia_vca_tpu"}
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "nubomedia_vca_tpu_torch" not in _imports(path), path
    for path in (BENCH / "frozen").rglob("*.py"):
        assert "nubomedia_vca_tpu_torch" not in _imports(path), path
