"""Generate the CNN eval labels with the PyTorch port — the counterpart
of ``tools/make_cnn_eval_labels.py``.

The learned detector's gates compare it against frozen teacher labels:
the cascade teacher's grouped detections (``distill.make_teacher``,
``label_batch``) on scenes regenerated from a stored seed by
``distill.make_scene``, with ignore regions where the teacher missed a
drawn face. This tool writes such a file with the port's teacher on
``--device``; its labels equal the frozen ``tests/data/cnn_eval_labels.npz``
for the same seed and count. The output path is the caller's: the frozen
file is the JAX package's and this tool does not rewrite it.

    python tools/torch_make_cnn_eval_labels.py --out labels.npz [--device cpu]

Drawing the scenes needs cv2. Runs on the card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

FROZEN = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "tests", "data", "cnn_eval_labels.npz"))


def make_labels(seed: int = 123, n: int = 32, device="cuda") -> dict:
    """The label file's arrays: `n` scenes drawn from `seed`, labelled by
    the teacher on `device`."""
    from nubomedia_vca_tpu_torch.models import distill

    rng = np.random.RandomState(seed)
    pairs = [distill.make_scene(rng, return_geom=True) for _ in range(n)]
    scenes = np.stack([p[0] for p in pairs])
    teacher = distill.make_teacher(device)
    boxes, valid, ign, ign_valid = distill.label_batch(
        teacher, scenes, [p[1] for p in pairs])
    return dict(seed=seed, n=n, boxes=boxes, valid=valid, ignore=ign,
                ignore_valid=ign_valid)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--out", required=True,
                    help="the .npz to write (not the frozen test file)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ns = ap.parse_args(argv)
    if os.path.abspath(ns.out) == FROZEN:
        ap.error(f"{ns.out} is the frozen label file; name another path")
    labels = make_labels(ns.seed, ns.n, ns.device)
    np.savez(ns.out, **labels)
    print(f"saved {ns.out}: {int(labels['valid'].sum())} teacher boxes, "
          f"{int(labels['ignore_valid'].sum())} ignore regions (teacher-"
          f"missed drawn faces) over {ns.n} scenes (seed {ns.seed})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
