// Survivor stages of a tilted cascade, for NVIDIA Hopper (sm_90a): the
// stages of one matmul block for the compacted survivor slots of one
// pyramid level, read from the level's sum and tilted tables in place.
//
// Replaces no TPU kernel: the JAX engine's survivor stages are XLA gathers
// and dots (nubomedia_vca_tpu/cascade/engine.py, _level_post). The port
// gathered each slot's (h0+1)x(w0+1) patch of both tables, cast it to
// float64 and multiplied it by dense [patch, features] matrices: at the
// eye filter's 320x180 about 2,185 GFLOP of float64 a 64-frame call, and
// gigabytes of patches in device memory, for features of 7 to 12 corners.
//
// Here one thread takes one slot; neighbouring slots (neighbouring windows
// of a level row, as the compaction keeps them in index order) take
// neighbouring threads, so a warp's corner reads fall on nearby addresses.
// A block is 256 slots of one frame (grid: slot tiles x frames). It stages
// the block's records (survivor_cuda.py, SurvivorPlan) in shared memory:
// per feature its rects' corner offsets, already multiplied by the level's
// row stride, the table and the integer weights; per weak tree its three
// feature ids, thresholds and leaves; the stage bounds and thresholds.
// Every thread reads the same record at the same time (warp-uniform). A
// block whose slots are all dead exits before staging; a dead slot writes
// 0 at once; a live slot leaves at its first failed stage (later stages
// cannot revive it) and evaluates only the child that a root selects.
//
// Arithmetic (as the plain version, survivor_eval_reference): a rect sum
// is t[o0] - t[o1] - t[o2] + t[o3] on the absolute table (uint32
// wraparound, read as int32), a feature the exact int32 sum of rect sums
// times integer weights, rounded once to float32 (__int2float_rn), times
// vnf (__fmul_rn); "<" thresholds and leaf selects; stage sums in weak-
// tree order (__fadd_rn; the library is built with -fmad=false); pass iff
// every stage sum >= its threshold.
//
// What bounds it: the corner reads. Each live slot reads 4 words per rect
// of one or two features per weak tree it reaches, from tables that stay
// in device memory (232 KB per table and frame at 320x180, so a frame's
// tables sit in L2 while its blocks run, and neighbouring windows share
// lines in L1). The arithmetic is a few integer adds per corner; tensor
// cores have no place in it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRects = 3;                     // MAX_RECTS
constexpr int kFeatWords = 2 + 5 * kMaxRects;    // FEAT_WORDS
constexpr int kTreeWords = 3 + 7;                // TREE_WORDS

// One feature of a window whose origin in both tables is iw, tw: the
// exact int32 sum of its rects' 4-corner sums times their weights.
__device__ __forceinline__ int32_t feature(const int* f,
                                           const uint32_t* __restrict__ iw,
                                           const uint32_t* __restrict__ tw) {
  const uint32_t* t = f[1] ? tw : iw;
  const int n = f[0];
  const int* o = f + 2;
  const int* w = f + 2 + 4 * kMaxRects;
  int32_t acc = 0;
#pragma unroll
  for (int r = 0; r < kMaxRects; ++r) {
    if (r < n) {
      const uint32_t s = __ldg(t + o[4 * r]) - __ldg(t + o[4 * r + 1]) -
                         __ldg(t + o[4 * r + 2]) + __ldg(t + o[4 * r + 3]);
      acc += static_cast<int32_t>(s) * w[r];
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
survivor_eval_kernel(const uint32_t* __restrict__ ii,
                     const uint32_t* __restrict__ iit,
                     const float* __restrict__ vnf,
                     const int64_t* __restrict__ win_ids,
                     const uint8_t* __restrict__ alive, int k, int sh,
                     int sw, int step, int nx, int ny,
                     const int* __restrict__ records, int n_feat,
                     int n_trees, int n_stages,
                     uint8_t* __restrict__ passed_out) {
  extern __shared__ int s_rec[];
  const int b = blockIdx.y;
  const int slot = blockIdx.x * kThreads + threadIdx.x;
  const size_t o = static_cast<size_t>(b) * k + slot;
  const bool live = slot < k && alive[o] != 0;
  if (!__syncthreads_or(live)) {
    if (slot < k) passed_out[o] = 0;
    return;
  }
  const int n_words =
      n_feat * kFeatWords + n_trees * kTreeWords + 2 * n_stages + 1;
  for (int i = threadIdx.x; i < n_words; i += kThreads) {
    s_rec[i] = __ldg(records + i);
  }
  __syncthreads();
  if (!live) {
    if (slot < k) passed_out[o] = 0;
    return;
  }
  const int* feats = s_rec;
  const int* trees = feats + n_feat * kFeatWords;
  const int* stage_lo = trees + n_trees * kTreeWords;
  const float* stage_thr = reinterpret_cast<const float*>(stage_lo) +
                           n_stages + 1;

  const int win = static_cast<int>(win_ids[o]);
  const int wy = win / nx, wx = win - wy * nx;
  const int w1 = sw + 1;
  const size_t base = static_cast<size_t>(b) * (sh + 1) * w1 +
                      static_cast<size_t>(wy * step) * w1 + wx * step;
  const uint32_t* iw = ii + base;
  const uint32_t* tw = iit + base;
  const float v = vnf[static_cast<size_t>(b) * ny * nx + win];

  bool ok = true;
  for (int s = 0; s < n_stages && ok; ++s) {
    float ssum = 0.0f;
    for (int t = stage_lo[s]; t < stage_lo[s + 1]; ++t) {
      const int* tree = trees + t * kTreeWords;
      const float* tf = reinterpret_cast<const float*>(tree + 3);
      const float f0 = __fmul_rn(
          __int2float_rn(feature(feats + tree[0] * kFeatWords, iw, tw)), v);
      const int side = (f0 < tf[0]) ? 1 : 2;  // left : right
      const int fc = tree[side];
      float leaf = tf[1 + 2 * side];  // a leaf child (threshold +inf)
      if (fc >= 0) {
        const float fv = __fmul_rn(
            __int2float_rn(feature(feats + fc * kFeatWords, iw, tw)), v);
        if (!(fv < tf[side])) leaf = tf[2 + 2 * side];
      }
      ssum = __fadd_rn(ssum, leaf);
    }
    ok = ssum >= stage_thr[s];
  }
  passed_out[o] = ok ? 1 : 0;
}

}  // namespace

// Lets the kernel take up to `max_smem_bytes` of dynamic shared memory on
// `device`: once per device, before its first launch there. Returns the
// CUDA error code (0 on success).
extern "C" int survivor_eval_init(int device, int max_smem_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(survivor_eval_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem_bytes));
}

// One block per (tile of 256 slots, frame) on `stream`, with `smem_bytes`
// (at most survivor_eval_init's) of records; returns the CUDA error code
// of the launch (0 on success).
extern "C" int survivor_eval_launch(int device, void* stream,
                                    const uint32_t* ii, const uint32_t* iit,
                                    const float* vnf, const int64_t* win_ids,
                                    const uint8_t* alive, int B, int k,
                                    int sh, int sw, int step, int nx, int ny,
                                    const int* records, int n_feat,
                                    int n_trees, int n_stages, int smem_bytes,
                                    uint8_t* passed_out) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((k + kThreads - 1) / kThreads, B);
  survivor_eval_kernel<<<grid, kThreads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      ii, iit, vnf, win_ids, alive, k, sh, sw, step, nx, ny, records, n_feat,
      n_trees, n_stages, passed_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* survivor_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
