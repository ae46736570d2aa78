// Pyramid dense phase of the Haar-cascade engine, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel build_pyramid_dense_phase
// (nubomedia_vca_tpu/ops/pallas/dense_pallas.py:371, evaluator
// _make_eval_dense :147, resize matrices _resize_matrix :351). Per frame and
// per pyramid level it:
//   1. makes the level image from the work image [B,H,W] u8 with
//      cv::resize INTER_LINEAR_EXACT semantics: direct 2-tap integer
//      arithmetic from the host index/coefficient tables (Q8 horizontal,
//      Q16 vertical, (v + 2^15) >> 16, clip); it writes the level image
//      except for the unscaled level, whose image is the work image;
//   2. builds the sum and squared-sum integral tables in shared memory, in
//      uint32 (wraparound) arithmetic; no table leaves the block;
//   3. per window of the level's ystep-strided grid, the variance
//      normalization and the first n_dense stages (dense_eval.cuh, which
//      also states the exactness rules);
//   4. writes vnf [B,ny,nx] f32 and alive [B,ny,nx] u8.
//
// What bounds it: a 720p frame brings a 160x90 work image (14.4 KB) in and
// a few KB of maps out, so device-memory traffic is negligible. The work is
// integer adds and shared-memory reads: the two tables (up to 161*121*8 B
// = 156 KB at 160x120) and about 6.6k strided windows per 720p frame, each
// reading 4 corners per rect of up to 40 weak trees. The layout keeps
// everything a level needs in one block's shared memory (opt-in above
// 48 KB), one block per (level, frame) so a batch of 64 frames fills the
// 132 SMs with 7 x 64 blocks, and one thread per strided window.

#include <cuda_runtime.h>

#include <cstdint>

#include "dense_eval.cuh"

namespace {

// Per-level int32 record; must match LEVEL_FIELDS in ops/cuda/dense_cuda.py.
constexpr int kSw = 0, kSh = 1, kStep = 2, kNx = 3, kNy = 4, kSame = 5,
              kImgBase = 6, kMapBase = 7, kRxOff = 8, kRyOff = 9,
              kLevelFields = 10;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pyramid_dense_kernel(const uint8_t* __restrict__ work, int H, int W,
                     const int* __restrict__ levels,
                     const int* __restrict__ rtab, DENSE_CASCADE_PARAMS,
                     uint8_t* __restrict__ img_out,
                     float* __restrict__ vnf_out,
                     uint8_t* __restrict__ alive_out) {
  extern __shared__ uint32_t smem[];
  const int* L = levels + blockIdx.x * kLevelFields;
  const int sw = L[kSw], sh = L[kSh], step = L[kStep], nx = L[kNx],
            ny = L[kNy];
  const bool same = L[kSame] != 0;
  const int b = blockIdx.y, B = gridDim.y;
  const int w1 = sw + 1;
  uint32_t* ii = smem;
  uint32_t* sq = smem + (sh + 1) * w1;
  const uint8_t* src = work + static_cast<size_t>(b) * H * W;

  // 1. zero top row and left column; level pixels (and their squares) at
  //    (y+1, x+1)
  for (int i = threadIdx.x; i < w1; i += blockDim.x) {
    ii[i] = 0u;
    sq[i] = 0u;
  }
  for (int y = threadIdx.x; y < sh; y += blockDim.x) {
    ii[(y + 1) * w1] = 0u;
    sq[(y + 1) * w1] = 0u;
  }
  const int* rx = rtab + L[kRxOff];  // s0[sw], s1[sw], c0[sw], c1[sw]
  const int* ry = rtab + L[kRyOff];  // s0[sh], s1[sh], c0[sh], c1[sh]
  uint8_t* img_l = img_out + static_cast<size_t>(B) * L[kImgBase] +
                   static_cast<size_t>(b) * sh * sw;
  for (int i = threadIdx.x; i < sh * sw; i += blockDim.x) {
    const int y = i / sw, x = i - y * sw;
    uint32_t p;
    if (same) {
      p = src[y * W + x];
    } else {
      const int x0 = rx[x], x1 = rx[sw + x];
      const int cx0 = rx[2 * sw + x], cx1 = rx[3 * sw + x];
      const uint8_t* r0 = src + ry[y] * W;
      const uint8_t* r1 = src + ry[sh + y] * W;
      const int h0 = r0[x0] * cx0 + r0[x1] * cx1;  // Q8
      const int h1 = r1[x0] * cx0 + r1[x1] * cx1;
      const int v = h0 * ry[2 * sh + y] + h1 * ry[3 * sh + y];  // Q16
      p = static_cast<uint32_t>(min(max((v + (1 << 15)) >> 16, 0), 255));
      img_l[i] = static_cast<uint8_t>(p);
    }
    ii[(y + 1) * w1 + x + 1] = p;
    sq[(y + 1) * w1 + x + 1] = p * p;
  }
  __syncthreads();

  // 2. prefix sums along rows, then along columns (uint32 wraparound)
  dense::prefix_tables(ii, sq, sh, sw);

  // 3.-5. one thread per window of the strided grid
  const size_t map0 = static_cast<size_t>(B) * L[kMapBase] +
                      static_cast<size_t>(b) * ny * nx;
  for (int w = threadIdx.x; w < ny * nx; w += blockDim.x) {
    const int iy = w / nx, ix = w - iy * nx;
    const int origin = iy * step * w1 + ix * step;
    float vnf;
    const bool alive =
        dense::eval_window<false>(ii + origin, sq + origin, nullptr, w1,
                                  DENSE_CASCADE_ARGS, &vnf);
    vnf_out[map0 + w] = vnf;
    alive_out[map0 + w] = alive ? 1 : 0;
  }
}

}  // namespace

// Launches one block per (level, frame) on `stream`. Returns the CUDA
// error code of the attribute call or of the launch (0 on success).
extern "C" int pyramid_dense_launch(
    int device, void* stream, const uint8_t* work, int B, int H, int W,
    const int* levels, int n_levels, const int* rtab, const int* feat_i,
    const float* feat_w, const int* weak_i, const float* weak_f, int n_weak,
    const float* stage_thr, int n_stages, int norm_w, int norm_h,
    float norm_area, float var_thr, int smem_bytes, uint8_t* img_out,
    float* vnf_out, uint8_t* alive_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(pyramid_dense_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_levels, B);
  pyramid_dense_kernel<<<grid, kThreads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      work, H, W, levels, rtab, DENSE_CASCADE_ARGS, img_out, vnf_out,
      alive_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pyramid_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
