// Window evaluation of the Haar-cascade dense phase, shared by the dense
// kernels (pyramid_dense.cu, dense_level.cu) in two forms: eval_window reads
// the cascade's feature and weak-tree tables from device memory (the row-
// strip kernel), eval_records reads per-level tree records with precomputed
// corner offsets from shared memory (the pyramid kernel and the tilted
// evaluation).
//
// Given a window's origin in the integral tables of its level (uint32,
// wraparound), it computes the variance normalization and runs the dense
// block's stages in exactly the float32 operation order of the engine's
// plain version (ops/cuda/dense_cuda.py, DenseTables.evaluate):
//   nf = area*sqsum - sum^2 (unfused), valid iff nf > 100*area^2,
//   vnf = 1/sqrt(max(nf, 1e-20)) (IEEE sqrt and reciprocal) else 1.0;
//   per feature: per rect float(sum) * weight, summed in rect order;
//   times vnf; "<" threshold selects; stage sums in weak-tree order;
//   alive &= ssum >= stage threshold.
// Every multiply and add is spelled __fmul_rn/__fadd_rn (and the libraries
// are built with -fmad=false), so nothing is contracted into an FMA. A
// window that fails a stage stops there (later stages cannot revive it),
// and only the child a weak tree selects is evaluated; the plain version
// evaluates both and selects, with the same result.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dense {

// Per feature: n_rects, (x, y, w, h) of up to kMaxRects rects, tilted flag.
// Must match DenseTables in ops/cuda/dense_cuda.py.
constexpr int kMaxRects = 3;
constexpr int kFeatTilted = 1 + 4 * kMaxRects;
constexpr int kFeatFields = kFeatTilted + 1;
// Per weak tree: int (feat0, featL, featR, stage);
// float (thr0, thrL, thrR, leafL0, leafL1, leafR0, leafR1).
constexpr int kWeakI = 4, kWeakF = 7;

// The dense block of one cascade, as device pointers and constants; the
// kernels take it as separate __restrict__ parameters (DENSE_CASCADE_PARAMS)
// and pass them on (DENSE_CASCADE_ARGS), which measured faster on an H100
// than reading the tables through a struct or through __ldg.
#define DENSE_CASCADE_PARAMS                                                 \
  const int *__restrict__ feat_i, const float *__restrict__ feat_w,          \
      const int *__restrict__ weak_i, const float *__restrict__ weak_f,      \
      int n_weak, const float *__restrict__ stage_thr, int n_stages,         \
      int norm_w, int norm_h, float norm_area, float var_thr
#define DENSE_CASCADE_ARGS                                                   \
  feat_i, feat_w, weak_i, weak_f, n_weak, stage_thr, n_stages, norm_w,       \
      norm_h, norm_area, var_thr

// Signed 4-corner rect sum on a table whose origin is the window's corner.
__device__ __forceinline__ uint32_t rect_sum(const uint32_t* t, int w1, int x,
                                             int y, int w, int h) {
  const uint32_t* r0 = t + y * w1 + x;
  const uint32_t* r1 = r0 + h * w1;
  return r0[0] - r0[w] - r1[0] + r1[w];
}

// Tilted rect on the tilted table:
// T[y,x] - T[y+w,x+w] - T[y+h,x-h] + T[y+w+h,x+w-h].
__device__ __forceinline__ uint32_t tilted_sum(const uint32_t* t, int w1,
                                               int x, int y, int w, int h) {
  return t[y * w1 + x] - t[(y + w) * w1 + x + w] - t[(y + h) * w1 + x - h] +
         t[(y + w + h) * w1 + x + w - h];
}

// kTilted: the dense block has tilted features (the feature's flag is read
// only then; a block without them never pays for the test).
template <bool kTilted>
__device__ __forceinline__ float feature_value(const uint32_t* iw,
                                               const uint32_t* tw, int w1,
                                               const int* fi,
                                               const float* fw) {
  const int n = fi[0];
  const bool tilted = kTilted && fi[kFeatTilted] != 0;
  float val = 0.0f;
  for (int r = 0; r < n; ++r) {
    const int* q = fi + 1 + 4 * r;
    const uint32_t s = tilted ? tilted_sum(tw, w1, q[0], q[1], q[2], q[3])
                              : rect_sum(iw, w1, q[0], q[1], q[2], q[3]);
    const float term =
        __fmul_rn(static_cast<float>(static_cast<int32_t>(s)), fw[r]);
    val = (r == 0) ? term : __fadd_rn(val, term);
  }
  return val;
}

// Variance normalization of one window (iw, qw: its origin in the sum and
// squared-sum tables of row length w1): writes vnf, returns whether the
// window's variance passes.
__device__ __forceinline__ bool norm_window(const uint32_t* iw,
                                            const uint32_t* qw, int w1,
                                            int norm_w, int norm_h,
                                            float norm_area, float var_thr,
                                            float* vnf_out) {
  const float vf = static_cast<float>(
      static_cast<int32_t>(rect_sum(iw, w1, 1, 1, norm_w, norm_h)));
  // the sq-sum is read as uint32 and rounded to nearest, like the engine's
  // bitcast-uint32 view
  const float sqf = static_cast<float>(rect_sum(qw, w1, 1, 1, norm_w, norm_h));
  const float nf = __fsub_rn(__fmul_rn(norm_area, sqf), __fmul_rn(vf, vf));
  const bool valid = nf > var_thr;
  *vnf_out = valid ? __frcp_rn(__fsqrt_rn(fmaxf(nf, 1e-20f))) : 1.0f;
  return valid;
}

// One window: iw, qw, tw point at the window's origin in the sum, squared
// sum and tilted tables (tw is not read unless kTilted), all of row length
// w1. Returns alive; writes vnf.
template <bool kTilted>
__device__ __forceinline__ bool eval_window(const uint32_t* iw,
                                            const uint32_t* qw,
                                            const uint32_t* tw, int w1,
                                            DENSE_CASCADE_PARAMS,
                                            float* vnf_out) {
  float vnf;
  bool alive =
      norm_window(iw, qw, w1, norm_w, norm_h, norm_area, var_thr, &vnf);

  int k = 0;
  for (int s = 0; s < n_stages && alive; ++s) {
    float ssum = 0.0f;
    for (; k < n_weak && weak_i[k * kWeakI + 3] == s; ++k) {
      const int* wi = weak_i + k * kWeakI;
      const float* wf = weak_f + k * kWeakF;
      const float f0 = __fmul_rn(
          feature_value<kTilted>(iw, tw, w1, feat_i + wi[0] * kFeatFields,
                                 feat_w + wi[0] * kMaxRects),
          vnf);
      const int side = (f0 < wf[0]) ? 1 : 2;  // featL : featR
      const float child = __fmul_rn(
          feature_value<kTilted>(iw, tw, w1, feat_i + wi[side] * kFeatFields,
                                 feat_w + wi[side] * kMaxRects),
          vnf);
      const float leaf =
          (child < wf[side]) ? wf[1 + 2 * side] : wf[2 + 2 * side];
      ssum = __fadd_rn(ssum, leaf);
    }
    alive = ssum >= stage_thr[s];
  }
  *vnf_out = vnf;
  return alive;
}

// ------------------------------------------------------------ tree records
// A weak tree as the record evaluator reads it (ops/cuda/dense_cuda.py,
// tile_records), for tables of row length `pitch`: its root, left and
// right features, each n rects, tilted flag, the 4 corner offsets of every
// rect from the window's origin, and the rects' weights; then thr0, thrL,
// thrR, leafL0, leafL1, leafR0, leafR1 and the stage. The kernels copy the
// records of a level to shared memory: every window reads the same ones
// (warp-uniform), and as dependent loads from device memory through L1
// they took a third of the tilted evaluation's time on an H100.
constexpr int kFeatWords = 2 + 5 * kMaxRects;
constexpr int kTreeWords = 3 * kFeatWords + kWeakF + 1;

// One feature of a window: per rect t[o0] - t[o1] - t[o2] + t[o3] on the
// sum or (kTilted and the feature's flag) the tilted table (both rect
// kinds are + - - + of 4 corners), times its weight, summed in rect order
// (feature_value's arithmetic).
template <bool kTilted>
__device__ __forceinline__ float record_feature(const int* f,
                                                const uint32_t* iw,
                                                const uint32_t* tw) {
  const uint32_t* t = (kTilted && f[1]) ? tw : iw;
  const float* w = reinterpret_cast<const float*>(f + 2 + 4 * kMaxRects);
  float val = 0.0f;
  for (int r = 0; r < f[0]; ++r) {
    const int* o = f + 2 + 4 * r;
    const uint32_t s = t[o[0]] - t[o[1]] - t[o[2]] + t[o[3]];
    const float term =
        __fmul_rn(static_cast<float>(static_cast<int32_t>(s)), w[r]);
    val = (r == 0) ? term : __fadd_rn(val, term);
  }
  return val;
}

// The variance normalization factor and the verdict of one window.
struct Window {
  float vnf;
  bool alive;
};

// One window over the tree records `trees` [n_weak][kTreeWords] and the
// stage thresholds `thr` (both in shared memory): iw, qw, tw point at the
// window's origin in the sum, squared-sum and tilted tables of row length
// `pitch` (tw is not read unless kTilted). eval_window's arithmetic and
// order. Compiled here, the tilted evaluation keeps 8 bytes of stack at
// 32 registers (its inline copy before kept none) and takes 3% longer on an
// H100; neither __restrict__ pointers nor a by-value result changed that.
template <bool kTilted>
__device__ __forceinline__ Window eval_records(
    const int* trees, int n_weak, const float* thr, int n_stages,
    const uint32_t* iw, const uint32_t* qw, const uint32_t* tw, int pitch,
    int norm_w, int norm_h, float norm_area, float var_thr) {
  float vnf;
  bool alive =
      norm_window(iw, qw, pitch, norm_w, norm_h, norm_area, var_thr, &vnf);
  int k = 0;
  for (int s = 0; s < n_stages && alive; ++s) {
    float ssum = 0.0f;
    for (; k < n_weak && trees[k * kTreeWords + kTreeWords - 1] == s; ++k) {
      const int* tree = trees + k * kTreeWords;
      const float* wf = reinterpret_cast<const float*>(tree + 3 * kFeatWords);
      const float f0 = __fmul_rn(record_feature<kTilted>(tree, iw, tw), vnf);
      const int side = (f0 < wf[0]) ? 1 : 2;  // left : right
      const float child = __fmul_rn(
          record_feature<kTilted>(tree + side * kFeatWords, iw, tw), vnf);
      const float leaf =
          (child < wf[side]) ? wf[1 + 2 * side] : wf[2 + 2 * side];
      ssum = __fadd_rn(ssum, leaf);
    }
    alive = ssum >= thr[s];
  }
  return {vnf, alive};
}

// Copies a level's tree records and the stage thresholds to shared memory
// (all threads of the block; the caller synchronises).
__device__ __forceinline__ void stage_records(int* __restrict__ s_trees,
                                              const int* __restrict__ trees,
                                              int n_weak,
                                              float* __restrict__ s_thr,
                                              const float* __restrict__ thr,
                                              int n_stages) {
  for (int i = threadIdx.x; i < n_weak * kTreeWords; i += blockDim.x) {
    s_trees[i] = trees[i];
  }
  for (int i = threadIdx.x; i < n_stages; i += blockDim.x) s_thr[i] = thr[i];
}

// Builds the sum and squared-sum tables of `rows` x `sw` pixels in place:
// the caller has stored pixel p at (y+1, x+1) of `ii` and p*p at the same
// place of `sq`, and zeros in row 0 and column 0. Prefix sums along rows,
// then along columns (uint32 wraparound). Ends with __syncthreads().
__device__ __forceinline__ void prefix_tables(uint32_t* ii, uint32_t* sq,
                                              int rows, int sw) {
  const int w1 = sw + 1;
  for (int y = threadIdx.x; y < rows; y += blockDim.x) {
    uint32_t* r = ii + (y + 1) * w1 + 1;
    uint32_t* q = sq + (y + 1) * w1 + 1;
    uint32_t a = 0u, c = 0u;
    for (int x = 0; x < sw; ++x) {
      a += r[x];
      r[x] = a;
      c += q[x];
      q[x] = c;
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < sw; x += blockDim.x) {
    uint32_t a = 0u, c = 0u;
    for (int y = 1; y <= rows; ++y) {
      const int k = y * w1 + x + 1;
      a += ii[k];
      ii[k] = a;
      c += sq[k];
      sq[k] = c;
    }
  }
  __syncthreads();
}

}  // namespace dense
