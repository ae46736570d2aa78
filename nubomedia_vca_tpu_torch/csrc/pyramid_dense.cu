// Pyramid dense phase of the Haar-cascade engine, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel build_pyramid_dense_phase
// (nubomedia_vca_tpu/ops/pallas/dense_pallas.py:371, evaluator
// _make_eval_dense :147, resize matrices _resize_matrix :351), and the
// row-strip form of build_dense_phase (strip_kernel :276, pallas_call :300,
// dense_strip_plan :116), which takes the levels too large for one block:
// a band of this kernel is such a strip, so every non-tilted level of an
// engine, its wide ones included, runs in one launch. Per frame and per
// pyramid level it:
//   1. makes the level image from the work image [B,H,W] u8 with
//      cv::resize INTER_LINEAR_EXACT semantics: direct 2-tap integer
//      arithmetic from the host index/coefficient tables (Q8 horizontal,
//      Q16 vertical, (v + 2^15) >> 16, clip); it writes the level image
//      except for the unscaled level, whose image is the work image;
//   2. builds the sum and squared-sum integral tables in shared memory, in
//      uint32 (wraparound) arithmetic; no table leaves the block;
//   3. per window of the level's ystep-strided grid, the variance
//      normalization and the first n_dense stages (dense_eval.cuh's
//      eval_records, which the tilted evaluation shares);
//   4. writes vnf [B,ny,nx] f32 and alive [B,ny,nx] u8.
//
// What bounds it: a 720p frame brings a 160x90 work image (14.4 KB) in and
// a few KB of maps out, so device-memory traffic is negligible. The work is
// integer adds and shared-memory reads: about 6.6k strided windows per 720p
// frame (the face engine), each reading 4 corners per rect of up to 40 weak
// trees, and the tables' prefix sums.
//
// Layout: one block per (band, frame). The host plan (dense_cuda.py,
// PyramidDensePlan) cuts every level into bands of whole window rows with
// similar window counts — a large level many, a small level one — and
// lists them as work items. A block resizes only its band's level rows
// plus the window_h - ystep halo that completes its last windows, builds
// band-local tables, and evaluates the band's windows (the last band of a
// level also resizes and writes the level's bottom rows that no window
// reads, without tabulating them). A rect sum is a
// 4-corner difference, so a band-local table gives the level table's sums
// (uint32 wraparound) and the results are bit for bit those of a
// whole-level table. Shared memory is sized by the largest band, not the
// largest level (the face plan: about 57 KB instead of 117 KB), so several
// blocks share an SM and the work is balanced across them; a wide level's
// bands are at least one grid row (window_h table rows) and up to about
// 107 KB at 320 px. Each level image row is written by the one band that
// owns it (rows [row0, own1)).
//   - Row prefix sums: one warp per band row, 32 pixels a step, an
//     inclusive warp scan (__shfl_up_sync) plus the running carry; the
//     resize of the row's pixels happens in the same pass. Column prefix
//     sums: one thread per column over the band's rows (a few dozen).
//   - The cascade's tree records (dense_cuda.tile_records with the
//     level's row length, sw + 1) and stage thresholds are copied to shared
//     memory: every window reads the same ones (warp-uniform), and read
//     through L1 as dependent loads they took a third of the tilted
//     evaluation's time on an H100. A plan with a level whose band tables
//     leave no room for them (wider than about 1300 px at a 20-px window)
//     reads them through L1 instead (the kernel's kStaged = false), so that
//     a band of one grid row is all a level needs.

#include <cuda_runtime.h>

#include <cstdint>

#include "dense_eval.cuh"

namespace {

// Per-level int32 record; must match LEVEL_FIELDS in ops/cuda/dense_cuda.py.
constexpr int kSw = 0, kSh = 1, kStep = 2, kNx = 3, kNy = 4, kSame = 5,
              kImgBase = 6, kMapBase = 7, kRxOff = 8, kRyOff = 9, kRecOff = 10,
              kLevelFields = 11;
// Per-band int32 record; must match ITEM_FIELDS in ops/cuda/dense_cuda.py.
constexpr int kLevel = 0, kIy0 = 1, kNRows = 2, kRow0 = 3, kRows = 4,
              kOwn1 = 5, kItemFields = 6;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
pyramid_band_kernel(const uint8_t* __restrict__ work, int H, int W,
                    const int* __restrict__ levels,
                    const int* __restrict__ items,
                    const int* __restrict__ rtab,
                    const int* __restrict__ trees, int n_weak,
                    const float* __restrict__ stage_thr, int n_stages,
                    int norm_w, int norm_h, float norm_area, float var_thr,
                    uint8_t* __restrict__ img_out,
                    float* __restrict__ vnf_out,
                    uint8_t* __restrict__ alive_out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int* it = items + blockIdx.x * kItemFields;
  const int* L = levels + it[kLevel] * kLevelFields;
  const int sw = L[kSw], sh = L[kSh], step = L[kStep], nx = L[kNx],
            ny = L[kNy];
  const bool same = L[kSame] != 0;
  const int iy0 = it[kIy0], n_rows = it[kNRows], row0 = it[kRow0],
            rows = it[kRows], own1 = it[kOwn1];
  const int b = blockIdx.y, B = gridDim.y;
  const int w1 = sw + 1;
  uint32_t* ii = smem;                                   // [rows+1][w1]
  uint32_t* sq = ii + (rows + 1) * w1;
  const int* recs = trees + L[kRecOff];
  const float* thr = stage_thr;
  const uint8_t* src = work + static_cast<size_t>(b) * H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (kStaged) {
    int* s_trees = reinterpret_cast<int*>(sq + (rows + 1) * w1);
    float* s_thr =
        reinterpret_cast<float*>(s_trees + n_weak * dense::kTreeWords);
    dense::stage_records(s_trees, recs, n_weak, s_thr, stage_thr, n_stages);
    recs = s_trees;
    thr = s_thr;
  }
  for (int i = threadIdx.x; i < w1; i += kThreads) {
    ii[i] = 0u;
    sq[i] = 0u;
  }

  // 1.-2. resize a band row and scan it, one warp per row; rows past the
  // tabulated ones (the last band's bottom rows) are resized and written
  const int n_resize = same ? rows : max(rows, own1 - row0);
  const int* rx = rtab + L[kRxOff];  // s0[sw], s1[sw], c0[sw], c1[sw]
  const int* ry = rtab + L[kRyOff];  // s0[sh], s1[sh], c0[sh], c1[sh]
  uint8_t* img_l = img_out + static_cast<size_t>(B) * L[kImgBase] +
                   static_cast<size_t>(b) * sh * sw;
  for (int r = warp; r < n_resize; r += kWarps) {
    const int y = row0 + r;
    const bool own = !same && y < own1;
    const bool tab = r < rows;  // warp-uniform
    const uint8_t* r0 = src + (same ? y : ry[y]) * W;
    const uint8_t* r1 = same ? r0 : src + ry[sh + y] * W;
    const int cy0 = same ? 0 : ry[2 * sh + y];
    const int cy1 = same ? 0 : ry[3 * sh + y];
    uint32_t* oi = ii + (r + 1) * w1;
    uint32_t* oq = sq + (r + 1) * w1;
    if (lane == 0 && tab) {
      oi[0] = 0u;
      oq[0] = 0u;
    }
    uint32_t ci = 0u, cq = 0u;
    for (int x0 = 0; x0 < sw; x0 += 32) {
      const int x = x0 + lane;
      uint32_t p = 0u;
      if (x < sw) {
        if (same) {
          p = r0[x];
        } else {
          const int x0s = rx[x], x1s = rx[sw + x];
          const int cx0 = rx[2 * sw + x], cx1 = rx[3 * sw + x];
          const int h0 = r0[x0s] * cx0 + r0[x1s] * cx1;  // Q8
          const int h1 = r1[x0s] * cx0 + r1[x1s] * cx1;
          const int v = h0 * cy0 + h1 * cy1;              // Q16
          p = static_cast<uint32_t>(min(max((v + (1 << 15)) >> 16, 0), 255));
          if (own) img_l[y * sw + x] = static_cast<uint8_t>(p);
        }
      }
      uint32_t a = p, q = p * p;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t na = __shfl_up_sync(kFull, a, o);
        const uint32_t nq = __shfl_up_sync(kFull, q, o);
        if (lane >= o) {
          a += na;
          q += nq;
        }
      }
      if (x < sw && tab) {
        oi[x + 1] = ci + a;
        oq[x + 1] = cq + q;
      }
      ci += __shfl_sync(kFull, a, 31);
      cq += __shfl_sync(kFull, q, 31);
    }
  }
  __syncthreads();
  // column prefix over the band's rows
  for (int x = 1 + threadIdx.x; x <= sw; x += kThreads) {
    uint32_t a = 0u, c = 0u;
    for (int k = w1 + x; k <= rows * w1 + x; k += w1) {
      a += ii[k];
      ii[k] = a;
      c += sq[k];
      sq[k] = c;
    }
  }
  __syncthreads();

  // 3.-4. one thread per window of the band
  const size_t map0 = static_cast<size_t>(B) * L[kMapBase] +
                      (static_cast<size_t>(b) * ny + iy0) * nx;
  for (int w = threadIdx.x; w < n_rows * nx; w += kThreads) {
    const int r = w / nx, ix = w - r * nx;
    const int origin = r * step * w1 + ix * step;
    const dense::Window win = dense::eval_records<false>(
        recs, n_weak, thr, n_stages, ii + origin, sq + origin, nullptr, w1,
        norm_w, norm_h, norm_area, var_thr);
    vnf_out[map0 + w] = win.vnf;
    alive_out[map0 + w] = win.alive ? 1 : 0;
  }
}

}  // namespace

// Launches one block per (band item, frame) on `stream`, the tree records
// staged in shared memory or not. Returns the CUDA error code of the
// attribute call or of the launch (0 on success).
extern "C" int pyramid_dense_launch(
    int device, void* stream, const uint8_t* work, int B, int H, int W,
    const int* levels, const int* items, int n_items, const int* rtab,
    const int* trees, int n_weak, const float* stage_thr, int n_stages,
    int norm_w, int norm_h, float norm_area, float var_thr, int smem_bytes,
    int staged, uint8_t* img_out, float* vnf_out, uint8_t* alive_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel =
      staged ? pyramid_band_kernel<true> : pyramid_band_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_items, B);
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      work, H, W, levels, items, rtab, trees, n_weak, stage_thr, n_stages,
      norm_w, norm_h, norm_area, var_thr, img_out, vnf_out, alive_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pyramid_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
