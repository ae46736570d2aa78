// Window evaluation of the Haar-cascade dense phase, shared by the dense
// kernels (pyramid_dense.cu, dense_level.cu): eval_records reads per-level
// tree records with precomputed corner offsets.
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

// Rects per Haar feature; must match MAX_RECTS in ops/cuda/dense_cuda.py.
constexpr int kMaxRects = 3;
// Per weak tree: float (thr0, thrL, thrR, leafL0, leafL1, leafR0, leafR1).
constexpr int kWeakF = 7;

// Signed 4-corner rect sum on a table whose origin is the window's corner.
__device__ __forceinline__ uint32_t rect_sum(const uint32_t* t, int w1, int x,
                                             int y, int w, int h) {
  const uint32_t* r0 = t + y * w1 + x;
  const uint32_t* r1 = r0 + h * w1;
  return r0[0] - r0[w] - r1[0] + r1[w];
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
// kinds are + - - + of 4 corners), times its weight, summed in rect
// order.
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
// stage thresholds `thr` (in shared memory, except in a pyramid launch with
// a level too wide to stage them): iw, qw, tw point at the window's origin
// in the sum, squared-sum and tilted tables of row length `pitch` (tw is
// not read unless kTilted). Compiled here, the tilted evaluation keeps 8
// bytes of stack at 32 registers (its inline copy before kept none) and
// takes 3% longer on an H100; neither __restrict__ pointers nor a by-value
// result changed that.
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

}  // namespace dense
