"""minNeighbors rectangle grouping — exact cv::groupRectangles semantics.

Port of ``nubomedia_vca_tpu/ops/grouping.py``. Rectangles are partitioned
into similarity classes (transitive closure of the SimilarRects predicate),
each class is averaged, classes with ≤ groupThreshold members are dropped,
and small classes nested inside stronger ones are suppressed.

Two implementations:
  * ``group_rectangles_np`` — host numpy, bit-exact vs OpenCV (a copy of the
    JAX package's).
  * ``group_rectangles_torch`` — fixed-capacity, batched over a leading
    dimension, on any device (the same math as the JAX package's
    ``group_rectangles_jax`` under ``jax.vmap``).
"""

from __future__ import annotations

import numpy as np
import torch


def _similar_matrix(rects: np.ndarray, eps: float) -> np.ndarray:
    """[N,4] x,y,w,h → [N,N] bool SimilarRects predicate matrix."""
    x, y, w, h = rects[:, 0], rects[:, 1], rects[:, 2], rects[:, 3]
    delta = eps * (np.minimum(w[:, None], w[None, :])
                   + np.minimum(h[:, None], h[None, :])) * 0.5
    return (
        (np.abs(x[:, None] - x[None, :]) <= delta)
        & (np.abs(y[:, None] - y[None, :]) <= delta)
        & (np.abs((x + w)[:, None] - (x + w)[None, :]) <= delta)
        & (np.abs((y + h)[:, None] - (y + h)[None, :]) <= delta)
    )


def group_rectangles_np(
    rects: np.ndarray, group_threshold: int, eps: float = 0.2,
    return_weights: bool = False,
):
    """Exact cv::groupRectangles. rects [N,4] int → grouped [M,4] int32."""
    rects = np.asarray(rects, dtype=np.int64).reshape(-1, 4)
    n = len(rects)
    if n == 0:
        out = np.zeros((0, 4), np.int32)
        return (out, np.zeros(0, np.int32)) if return_weights else out

    sim = _similar_matrix(rects, eps)
    # union-find transitive closure
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in np.nonzero(sim[i])[0]:
            if j <= i:
                continue
            ri, rj = find(i), find(int(j))
            if ri != rj:
                parent[rj] = ri

    labels = np.array([find(i) for i in range(n)])
    classes = np.unique(labels)
    sums = np.zeros((len(classes), 4), np.int64)
    counts = np.zeros(len(classes), np.int64)
    for ci, c in enumerate(classes):
        members = rects[labels == c]
        sums[ci] = members.sum(0)
        counts[ci] = len(members)

    # average with cvRound (half-to-even)
    avg = np.rint(sums / counts[:, None]).astype(np.int64)

    # drop weak classes, then suppress small-inside-large
    keep = []
    for i in range(len(classes)):
        n1 = counts[i]
        if n1 <= group_threshold:
            continue
        r1 = avg[i]
        inside = False
        for j in range(len(classes)):
            n2 = counts[j]
            if j == i or n2 <= group_threshold:
                continue
            r2 = avg[j]
            dx = int(np.rint(r2[2] * eps))
            dy = int(np.rint(r2[3] * eps))
            if (
                r1[0] >= r2[0] - dx
                and r1[1] >= r2[1] - dy
                and r1[0] + r1[2] <= r2[0] + r2[2] + dx
                and r1[1] + r1[3] <= r2[1] + r2[3] + dy
                and (n2 > max(3, n1) or n1 < 3)
            ):
                inside = True
                break
        if not inside:
            keep.append(i)

    out = avg[keep].astype(np.int32)
    if return_weights:
        return out, counts[keep].astype(np.int32)
    return out


def group_rectangles_torch(
    rects: torch.Tensor, valid: torch.Tensor, group_threshold: int,
    eps: float = 0.2,
):
    """Fixed-capacity grouping, batched over the leading dimension.

    rects: [B, N, 4] int32 (padded), valid: [B, N] bool.
    Returns (avg_rects [B,N,4] int32, out_valid [B,N] bool,
    weights [B,N] int32): one output slot per similarity class (at the
    position of its smallest member index); padding slots invalid.
    """
    rects = rects.to(torch.int32)
    B, n = rects.shape[:2]
    dev = rects.device
    x, y, w, h = rects.unbind(-1)

    def pair(a):          # [B, N] → ([B, N, 1], [B, 1, N])
        return a[:, :, None], a[:, None, :]

    (wi, wj), (hi, hj) = pair(w), pair(h)
    delta = (eps * (torch.minimum(wi, wj) + torch.minimum(hi, hj))
             ).to(torch.float32) * 0.5

    def close(a):
        ai, aj = pair(a)
        return (ai - aj).abs() <= delta

    vi, vj = pair(valid)
    sim = close(x) & close(y) & close(x + w) & close(y + h) & vi & vj

    # exact transitive closure by repeated boolean matrix squaring: after k
    # squarings sim covers all paths of length <= 2^k. The 0/1 products
    # sum to at most N, exact in float32.
    n_rounds = max(1, int(np.ceil(np.log2(max(n, 2)))))
    s = sim.to(torch.float32)
    for _ in range(n_rounds):
        s = torch.clamp(s + torch.bmm(s, s), max=1.0)
    idx = torch.arange(n, device=dev)
    # class label = smallest connected member index
    first = torch.where(s > 0.0, idx, n).amin(dim=2)
    labels = torch.where(valid, first, n)

    # per-class member counts and coordinate sums (slot n collects padding)
    counts = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, labels, torch.ones_like(labels, dtype=torch.int32))
    sums = torch.zeros((B, n + 1, 4), dtype=torch.int32, device=dev)
    sums.scatter_add_(1, labels[:, :, None].expand(-1, -1, 4), rects)
    counts, sums = counts[:, :n], sums[:, :n]
    avg = torch.where(
        counts[:, :, None] > 0,
        torch.round(sums.to(torch.float32)
                    / counts.clamp(min=1)[:, :, None]).to(torch.int32),
        0)

    strong = counts > group_threshold
    # small-inside-large suppression
    ax, ay, aw, ah = avg.unbind(-1)
    dx = torch.round(aw * eps).to(torch.int32)
    dy = torch.round(ah * eps).to(torch.int32)
    ci, cj = pair(counts)
    inside = (
        (ax[:, :, None] >= (ax - dx)[:, None, :])
        & (ay[:, :, None] >= (ay - dy)[:, None, :])
        & ((ax + aw)[:, :, None] <= (ax + aw + dx)[:, None, :])
        & ((ay + ah)[:, :, None] <= (ay + ah + dy)[:, None, :])
        & (idx[:, None] != idx[None, :])
        & strong[:, None, :]
        & ((cj > torch.clamp(ci, min=3)) | (ci < 3))
    )
    out_valid = strong & ~inside.any(dim=2)
    return avg, out_valid, counts
