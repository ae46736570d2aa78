"""Haar-cascade trainer — the framework's opencv_traincascade analog.

The reference consumes cascades trained elsewhere (2001-era mcs models it
cannot redistribute, kmsnosedetect.cpp:32, kmseardetect.cpp:30-31); this
module closes the asset gap by training new ones: discrete-AdaBoost stumps
over the classic Haar feature set, assembled into an attentional cascade
with per-stage hard-negative mining, emitted as NEW-FORMAT OpenCV cascade
XML that cascade/xml_loader.py (and OpenCV itself) loads.

Evaluation semantics are IDENTICAL to cascade/engine.py by construction:

  * feature value  = Σ weight_r · rectsum_r(window)        (integral sums)
  * normalization  = value · vnf,  vnf = 1/sqrt(area·sqsum − sum²) over
    the (1,1,w−2,h−2) norm rect — the engine's variance normalization
    (engine.py:436-447);
  * windows whose nf ≤ 100·area² (pixel std ≤ 10) are invalid — such
    positives are dropped at training time because detection can never
    fire on them.

Features for ALL samples evaluate as one (samples × patch-pixels) ×
(patch-pixels × features) matmul — the same corner-weight decomposition
the engine's pyramid route uses (engine.py:_matmul_block) — so training is a
couple of big GEMMs per boosting round.

A copy of ``nubomedia_vca_tpu/cascade/train.py`` in which those GEMMs
(``feature_values``) run as float32 torch matmuls on a device, the card
unless the caller asks for another. Everything else (the integral
patches, the variance normalization in float64, the stumps' float64
histograms, the weight updates, the stage thresholds and the mining loop)
stays the JAX module's numpy on the host. The GEMM is exact in any
summation order: an integral patch holds integers up to w·h·255 and a
corner-matrix column integers whose absolute values sum to at most 40, so
every partial sum is an integer below 2^24 (``check_exact_gemm`` holds
that for the window and the pool, and raises otherwise), and a float32
matmul that does not round through TF32 computes it exactly. So the card,
the CPU and the JAX package give the same values bit for bit, and the
same training run writes the same XML bytes on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine import _check_true_f32_matmul, _resolve_device

F32_EXACT = 2 ** 24   # integers float32 holds exactly


# ------------------------------------------------------------- feature pool
def feature_pool(w: int, h: int, pos_step: int = 2, size_step: int = 2,
                 max_features: int | None = None, seed: int = 0):
    """Classic Haar feature templates inside a (w,h) window.

    Returns a list of rect lists [(x, y, rw, rh, weight), ...] using the
    new-format XML weight convention (whole rect −1, bright sub-rect +2/+3,
    center-surround +9) — ≤ MAX_RECTS(3) rects each, loader-compatible.
    """
    feats = []

    def add(rects):
        feats.append(rects)

    for rw in range(size_step, w + 1, size_step):
        for rh in range(size_step, h + 1, size_step):
            for x in range(0, w - rw + 1, pos_step):
                for y in range(0, h - rh + 1, pos_step):
                    if rw % 2 == 0:   # horizontal 2-rect (haar_x2)
                        add([(x, y, rw, rh, -1.0),
                             (x + rw // 2, y, rw // 2, rh, 2.0)])
                    if rh % 2 == 0:   # vertical 2-rect (haar_y2)
                        add([(x, y, rw, rh, -1.0),
                             (x, y + rh // 2, rw, rh // 2, 2.0)])
                    if rw % 3 == 0:   # horizontal 3-rect (haar_x3)
                        add([(x, y, rw, rh, -1.0),
                             (x + rw // 3, y, rw // 3, rh, 3.0)])
                    if rh % 3 == 0:   # vertical 3-rect (haar_y3)
                        add([(x, y, rw, rh, -1.0),
                             (x, y + rh // 3, rw, rh // 3, 3.0)])
                    if rw % 3 == 0 and rh % 3 == 0:  # center-surround
                        add([(x, y, rw, rh, -1.0),
                             (x + rw // 3, y + rh // 3,
                              rw // 3, rh // 3, 9.0)])
    if max_features is not None and len(feats) > max_features:
        rng = np.random.RandomState(seed)
        sel = rng.choice(len(feats), max_features, replace=False)
        feats = [feats[i] for i in sorted(sel)]
    return feats


def corner_matrix(feats, w: int, h: int) -> np.ndarray:
    """[(h+1)·(w+1), F] float32: integral-patch → feature-value map (the
    engine's corner-weight decomposition, engine.py:_make_block)."""
    pw = w + 1
    mat = np.zeros(((h + 1) * pw, len(feats)), np.float32)
    for f, rects in enumerate(feats):
        for (x, y, rw, rh, wt) in rects:
            for (dy, dx, s) in ((y, x, 1), (y, x + rw, -1),
                                (y + rh, x, -1), (y + rh, x + rw, 1)):
                mat[dy * pw + dx, f] += s * wt
    return mat


# -------------------------------------------------------- sample evaluation
def integral_patches(samples: np.ndarray) -> np.ndarray:
    """[N,h,w] uint8 → [N,(h+1)(w+1)] float32 integral images (exact:
    values ≤ 20·20·255 ≪ 2^24)."""
    N, h, w = samples.shape
    ii = np.zeros((N, h + 1, w + 1), np.float32)
    ii[:, 1:, 1:] = np.cumsum(np.cumsum(samples.astype(np.int64), axis=1),
                              axis=2).astype(np.float32)
    return ii.reshape(N, -1)


def vnf_and_valid(samples: np.ndarray):
    """Per-sample variance-normalization factor + validity over the
    (1,1,w−2,h−2) norm rect — exactly engine.py:436-447."""
    N, h, w = samples.shape
    inner = samples[:, 1:h - 1, 1:w - 1].astype(np.float64)
    area = float((w - 2) * (h - 2))
    s = inner.sum(axis=(1, 2))
    sq = (inner * inner).sum(axis=(1, 2))
    nf = area * sq - s * s
    valid = nf > 100.0 * area * area
    vnf = np.where(valid, 1.0 / np.sqrt(np.maximum(nf, 1e-20)), 1.0)
    return vnf.astype(np.float32), valid


def check_exact_gemm(mat: np.ndarray, w: int, h: int) -> None:
    """Raise unless ``integral patch @ mat`` is exact in float32 in any
    summation order: `mat` must hold integers, and the largest patch value
    (w·h·255) times the largest absolute column sum of `mat` must stay
    below 2^24."""
    if mat.shape[0] != (h + 1) * (w + 1):
        raise ValueError(f"corner matrix has {mat.shape[0]} rows, a {w}x{h} "
                         f"window's patch {(h + 1) * (w + 1)}")
    if not np.array_equal(mat, np.round(mat)):
        raise ValueError("corner matrix holds non-integer weights")
    col = float(np.abs(mat).sum(axis=0).max()) if mat.size else 0.0
    most = w * h * 255 * col
    if most >= F32_EXACT:
        raise ValueError(
            f"feature GEMM not exact in float32: a {w}x{h} window's patch "
            f"values reach {w * h * 255} and a feature's corner weights sum "
            f"to {col:g}, so partial sums reach {most:g} >= 2^24")


def feature_values(samples: np.ndarray, mat: np.ndarray,
                   chunk: int = 2048,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """[N,h,w] uint8 → normalized feature values [N,F] float32. The
    patch x corner-matrix GEMM runs in float32 on `device`, exactly
    (``check_exact_gemm``); the normalization is the JAX module's."""
    _check_true_f32_matmul("the cascade trainer")
    dev = _resolve_device(device)
    n, h, w = samples.shape
    check_exact_gemm(mat, w, h)
    vnf, _ = vnf_and_valid(samples)
    patches = integral_patches(samples)
    m = torch.from_numpy(np.ascontiguousarray(mat)).to(dev)
    out = np.empty((n, mat.shape[1]), np.float32)
    for i in range(0, n, chunk):
        p = torch.from_numpy(patches[i:i + chunk]).to(dev)
        out[i:i + chunk] = (p @ m).cpu().numpy()
    return out * vnf[:, None]


# ------------------------------------------------------------- boosting
def _best_stump(vals, y, wts, n_bins=96):
    """Globally best decision stump over all features.

    Returns (feat, threshold, polarity, err). polarity +1 ⇒ predict
    positive when value < threshold."""
    N, F = vals.shape
    lo = vals.min(axis=0)
    hi = vals.max(axis=0)
    scale = (n_bins - 1) / np.maximum(hi - lo, 1e-12)
    bins = ((vals - lo) * scale).astype(np.int32)        # [N, F]
    offs = bins + n_bins * np.arange(F, dtype=np.int64)[None, :]
    pos = y > 0
    wpos = np.bincount(offs[pos].ravel(),
                       weights=np.repeat(wts[pos], F),
                       minlength=n_bins * F).reshape(F, n_bins)
    wneg = np.bincount(offs[~pos].ravel(),
                       weights=np.repeat(wts[~pos], F),
                       minlength=n_bins * F).reshape(F, n_bins)
    cpos = np.cumsum(wpos, axis=1)       # weight of positives with bin ≤ b
    cneg = np.cumsum(wneg, axis=1)
    tpos, tneg = cpos[:, -1:], cneg[:, -1:]
    # cut after bin b; left = bins ≤ b
    err_p1 = (tpos - cpos) + cneg        # predict + on left
    err_m1 = cpos + (tneg - cneg)        # predict + on right
    e1 = err_p1.min()
    e2 = err_m1.min()
    if e1 <= e2:
        f, b = np.unravel_index(np.argmin(err_p1), err_p1.shape)
        pol, err = 1, float(e1)
    else:
        f, b = np.unravel_index(np.argmin(err_m1), err_m1.shape)
        pol, err = -1, float(e2)
    thr = lo[f] + (b + 1) / scale[f]     # boundary just above bin b
    return int(f), float(thr), pol, err


@dataclasses.dataclass
class Weak:
    feat: int
    threshold: float
    left_val: float     # value when featval < threshold
    right_val: float


@dataclasses.dataclass
class Stage:
    weaks: list
    threshold: float


@dataclasses.dataclass
class TrainedCascade:
    window_w: int
    window_h: int
    feats: list          # rect lists (feature_pool entries), index space
    stages: list         # of Stage


@dataclasses.dataclass
class TrainConfig:
    window: tuple = (20, 20)
    n_stages: int = 8
    max_weaks_per_stage: int = 40
    min_detection_rate: float = 0.995   # per stage, on the training positives
    max_fp_rate: float = 0.5            # per stage, on the stage's negatives
    n_pos: int = 3000
    n_neg: int = 6000
    max_features: int = 4000
    pos_step: int = 2
    size_step: int = 2
    n_bins: int = 96
    seed: int = 0
    verbose: bool = True


def _stage_scores(samples, mat, stage_weaks, device="cuda"):
    vals = feature_values(samples, mat, device=device)
    score = np.zeros(samples.shape[0], np.float32)
    for wk in stage_weaks:
        score += np.where(vals[:, wk.feat] < wk.threshold,
                          wk.left_val, wk.right_val)
    return score


def cascade_pass(samples, mat, stages, device="cuda"):
    """Boolean mask of samples passing every stage (window-level detector
    decision, minus the variance-validity gate); the feature GEMMs run on
    `device`."""
    alive = np.ones(samples.shape[0], bool)
    for st in stages:
        if not alive.any():
            break
        idx = np.nonzero(alive)[0]
        sc = _stage_scores(samples[idx], mat, st.weaks, device)
        alive[idx[sc < st.threshold]] = False
    return alive


def train_cascade(pos_sampler, neg_sampler,
                  config: TrainConfig | None = None,
                  device: str | torch.device = "cuda") -> TrainedCascade:
    """pos_sampler(n, rng) / neg_sampler(n, rng) → [n,h,w] uint8 crops at
    the window size. Returns the trained cascade (write_cascade_xml to
    ship it). The feature GEMMs run on `device`; the same run gives the
    same cascade on every device. Raises before sampling when the GEMM
    would not be exact for the window and the pool."""
    cfg = config or TrainConfig()
    w, h = cfg.window
    _check_true_f32_matmul("the cascade trainer")
    dev = _resolve_device(device)
    rng = np.random.RandomState(cfg.seed)
    feats = feature_pool(w, h, cfg.pos_step, cfg.size_step,
                         cfg.max_features, cfg.seed)
    mat = corner_matrix(feats, w, h)
    check_exact_gemm(mat, w, h)

    pos = pos_sampler(cfg.n_pos, rng)
    _, pvalid = vnf_and_valid(pos)
    if not pvalid.all() and cfg.verbose:
        print(f"dropping {int((~pvalid).sum())} low-variance positives "
              "(std ≤ 10 can never detect)", flush=True)
    pos = pos[pvalid]

    def mine_negatives(n, stages, max_batches=40):
        """Negatives passing all trained stages so far (hard negatives).
        Bails out early when the fresh-negative acceptance rate is too low
        to ever fill the quota — a cascade that rejects fresh negatives at
        <1e-3 per window is done; grinding the sampler is wasted time."""
        out, raw = [], 0
        for b in range(max_batches):
            cand = neg_sampler(n, rng)
            raw += len(cand)
            _, nvalid = vnf_and_valid(cand)
            cand = cand[nvalid]
            if stages:
                cand = cand[cascade_pass(cand, mat, stages, dev)]
            if len(cand):
                out.append(cand)
            got = sum(len(c) for c in out)
            if got >= n:
                break
            if b >= 9 and got < (b + 1) * n // (2 * max_batches):
                break   # projected total < n/2 — accept the shortfall
        return (np.concatenate(out)[:n] if out
                else np.empty((0, h, w), np.uint8))

    stages: list[Stage] = []
    for s_idx in range(cfg.n_stages):
        neg = mine_negatives(cfg.n_neg, stages)
        if len(neg) < max(200, cfg.n_neg // 20):
            if cfg.verbose:
                print(f"stage {s_idx}: negative pool exhausted "
                      f"({len(neg)} hard negatives) — cascade complete",
                      flush=True)
            break
        samples = np.concatenate([pos, neg])
        y = np.concatenate([np.ones(len(pos)), -np.ones(len(neg))])
        vals = feature_values(samples, mat, device=dev)
        wts = np.full(len(y), 1.0 / len(y))
        score = np.zeros(len(y), np.float32)
        weaks: list[Weak] = []
        thr = 0.0
        for _ in range(cfg.max_weaks_per_stage):
            f, t, pol, err = _best_stump(vals, y, wts, cfg.n_bins)
            err = min(max(err, 1e-10), 1 - 1e-10)
            alpha = 0.5 * np.log((1 - err) / err)
            lv, rv = pol * alpha, -pol * alpha
            wk = Weak(f, t, float(lv), float(rv))
            weaks.append(wk)
            hx = np.where(vals[:, f] < t, lv, rv)
            score += hx
            wts = wts * np.exp(-y * hx)
            wts /= wts.sum()
            # stage threshold at the min_detection_rate quantile of
            # positive scores (opencv_traincascade's minHitRate search)
            ps = np.sort(score[:len(pos)])
            k = int(np.floor((1 - cfg.min_detection_rate) * len(ps)))
            thr = float(ps[k]) - 1e-6
            fp = float((score[len(pos):] >= thr).mean())
            if fp <= cfg.max_fp_rate:
                break
        stages.append(Stage(weaks, thr))
        det = float((score[:len(pos)] >= thr).mean())
        if cfg.verbose:
            print(f"stage {s_idx}: {len(weaks)} weaks, det {det:.4f}, "
                  f"fp {fp:.4f}, thr {thr:.4f}", flush=True)
        pos = pos[_stage_scores(pos, mat, weaks, dev) >= thr]
    return TrainedCascade(w, h, feats, stages)


# ----------------------------------------------------------------- XML out
def write_cascade_xml(path: str, model: TrainedCascade) -> None:
    """Emit NEW-FORMAT OpenCV cascade XML (the format of
    haarcascade_frontalface_alt.xml; the root child must be literally
    <cascade> for both our loader and OpenCV). Only features used by some
    weak are emitted (reindexed)."""
    used = sorted({wk.feat for st in model.stages for wk in st.weaks})
    remap = {f: i for i, f in enumerate(used)}
    lines = [
        '<?xml version="1.0"?>',
        "<opencv_storage>",
        '<cascade type_id="opencv-cascade-classifier"><stageType>BOOST'
        "</stageType>",
        "  <featureType>HAAR</featureType>",
        f"  <height>{model.window_h}</height>",
        f"  <width>{model.window_w}</width>",
        "  <stageParams>",
        "    <boostType>DAB</boostType>",
        "    <minHitRate>0.9950000047683716</minHitRate>",
        "    <maxFalseAlarm>0.5</maxFalseAlarm>",
        "    <weightTrimRate>1.</weightTrimRate>",
        "    <maxDepth>1</maxDepth>",
        f"    <maxWeakCount>{max((len(s.weaks) for s in model.stages), default=0)}</maxWeakCount></stageParams>",
        "  <featureParams>",
        "    <maxCatCount>0</maxCatCount>",
        "    <featSize>1</featSize>",
        "    <mode>BASIC</mode></featureParams>",
        f"  <stageNum>{len(model.stages)}</stageNum>",
        "  <stages>",
    ]
    for st in model.stages:
        lines += [
            "    <_>",
            f"      <maxWeakCount>{len(st.weaks)}</maxWeakCount>",
            f"      <stageThreshold>{st.threshold!r}</stageThreshold>",
            "      <weakClassifiers>",
        ]
        for wk in st.weaks:
            lines += [
                "        <_>",
                "          <internalNodes>",
                f"            0 -1 {remap[wk.feat]} {wk.threshold!r}"
                "</internalNodes>",
                "          <leafValues>",
                f"            {wk.left_val!r} {wk.right_val!r}"
                "</leafValues></_>",
            ]
        lines += ["      </weakClassifiers></_>"]
    lines += ["  </stages>", "  <features>"]
    for f in used:
        lines += ["    <_>", "      <rects>"]
        for (x, y, rw, rh, wt) in model.feats[f]:
            lines += [f"        <_>{x} {y} {rw} {rh} {wt!r}</_>"]
        lines += ["      </rects>",
                  "      <tilted>0</tilted></_>"]
    lines += ["  </features></cascade>", "</opencv_storage>", ""]
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
