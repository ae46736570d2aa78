"""Train and ship the synthetic part cascades (nose, ear, profile face) on
the PyTorch port — the counterpart of ``tools/train_part_cascades.py``.

The port's trainer (``cascade/train.py``, an opencv_traincascade analog
whose feature GEMMs run on ``--device``) builds the substitutes for the
reference's mcs nose and ear cascades on procedural scenes
(``models/synth.py``, which draws with cv2), checks each on a window-level
holdout (detection on positives, false positives on clean and textured
negatives) and refuses to write one whose holdout detection is under 0.9.
The same run writes the same XML bytes on every device.

    python tools/torch_train_part_cascades.py [--out-dir DIR] [--parts nose]

The default output directory is the port's bundled
``nubomedia_vca_tpu_torch/assets/haarcascades``. Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


SPECS = {
    "nose": "vca_nose_synthetic.xml",
    "ear": "vca_ear_synthetic.xml",
    "profile": "vca_profileface_synthetic.xml",
}
# the shipped cascades' recipe: 8 stages of up to 40 weaks from a pool of
# 3000 features, 3000 positives and 8000 negatives a stage
RECIPE = dict(n_stages=8, n_pos=3000, n_neg=8000, max_features=3000,
              max_weaks_per_stage=40)
HOLDOUT_POS, HOLDOUT_NEG = 800, 3000
MIN_HOLDOUT_DET = 0.9


def recipe_samplers(part: str):
    """(positives, negatives, holdout negatives {name: sampler}) of the
    recipe: training negatives with a 25% share of the texture families,
    holdout on the clean scene negatives and on the textures alone. The
    texture share is additive (n_neg 8000 at 0.25): the scene negatives
    stay at the count the localization gates need. Needs cv2."""
    from nubomedia_vca_tpu_torch.models.synth import (make_samplers,
                                                      make_texture_sampler)

    pos_s, neg_s = make_samplers(part, texture_neg_frac=0.25)
    return pos_s, neg_s, {
        "clean": make_samplers(part, texture_neg_frac=0.0)[1],
        "textured": make_texture_sampler()}


def train_one(part: str, out_path: str, seed: int = 0, device="cuda",
              cfg=None, samplers=None) -> dict:
    """Train one part cascade on `device` and write it to `out_path` if
    its holdout detection reaches 0.9 (else SystemExit, nothing written).
    `cfg` defaults to the recipe at `seed`; `samplers` (positives,
    negatives, {holdout name: negatives}) to ``recipe_samplers(part)``.
    Returns the trained cascade, its holdout rates and the seconds the
    training took."""
    from nubomedia_vca_tpu_torch.cascade.train import (
        TrainConfig, cascade_pass, corner_matrix, train_cascade,
        vnf_and_valid, write_cascade_xml)

    pos_s, neg_s, holdout = samplers or recipe_samplers(part)
    cfg = cfg or TrainConfig(**RECIPE, seed=seed)
    t0 = time.time()
    model = train_cascade(pos_s, neg_s, cfg, device=device)
    seconds = time.time() - t0
    print(f"{part}: {len(model.stages)} stages in {seconds:.0f}s")

    # window-level holdout, validity-filtered (the engine rejects
    # low-variance windows before the cascade sees them)
    rng = np.random.RandomState(seed + 999)
    P = pos_s(HOLDOUT_POS, rng)
    negs = {name: s(HOLDOUT_NEG, rng) for name, s in holdout.items()}
    mat = corner_matrix(model.feats, *cfg.window)
    _, pv = vnf_and_valid(P)
    det = float(cascade_pass(P[pv], mat, model.stages, device).mean())
    fps = {}
    for name, N in negs.items():
        _, nv = vnf_and_valid(N)
        fps[name] = float(cascade_pass(N[nv], mat, model.stages,
                                       device).mean())
    print(f"{part}: holdout window det {det:.4f}, " + ", ".join(
        f"fp {name} {v:.5f}" for name, v in fps.items()))
    if det < MIN_HOLDOUT_DET:
        raise SystemExit(f"{part}: detection rate too low, not shipping")
    write_cascade_xml(out_path, model)
    print(f"{part}: wrote {out_path}")
    return {"model": model, "det": det, "fp": fps, "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    default_out = os.path.join(os.path.dirname(__file__), "..",
                               "nubomedia_vca_tpu_torch", "assets",
                               "haarcascades")
    ap.add_argument("--out-dir", default=default_out)
    ap.add_argument("--parts", nargs="*", default=list(SPECS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ns = ap.parse_args(argv)
    os.makedirs(ns.out_dir, exist_ok=True)
    for part in ns.parts:
        train_one(part, os.path.join(ns.out_dir, SPECS[part]), ns.seed,
                  ns.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
