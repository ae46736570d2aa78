// Dense phase of one pre-resized pyramid level, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel build_dense_phase
// (nubomedia_vca_tpu/ops/pallas/dense_pallas.py:221) in its two forms:
//
// * tilted (the single-block kernel, pallas_call :329, with the in-kernel
//   rotated table): one block per frame builds the sum, squared-sum and
//   tilted tables of the whole level in shared memory, evaluates the dense
//   block on the level's ystep-strided window grid, and writes vnf, alive
//   and the sum and tilted tables (the engine gathers survivor patches
//   from them);
// * row strips (strip_kernel :276, pallas_call :300, dense_strip_plan
//   :116): for non-tilted levels too large for one block, one block per
//   (strip, frame) builds strip-local sum and squared-sum tables of
//   strip_gy + h0 - 1 level rows (the h0 - 1 halo rows complete the
//   windows that start in the strip) and evaluates the windows whose
//   origin row lies in the strip. A rect sum is a 4-corner difference, so
//   a strip-local table gives the same sums as the level's table (uint32
//   wraparound), and the results equal a whole-level evaluation. strip_gy
//   is a multiple of ystep, so the strided rows of the level land on rows
//   0, ystep, ... of every strip; the last strip is ragged and simply has
//   fewer rows. With a single strip this is the non-tilted single block.
//
// The tilted table, T(y, x) = sum of pixels (y', x') with y' < y and
// |x' - (x - 1)| <= y - y' - 1, is built without padding from the sum
// table: with C[y'][j] = ii[y'+1][j] - ii[y'][j] the exclusive prefix of
// pixel row y' (j clamped to [0, W]),
//   T(y, x) = A(y, x) - D(y, x),
//   A(y, x) = sum_{y'<y} C[y'][x + y - 1 - y'],  A(y, x) = A(y-1, x+1) + C[y-1][x],
//   D(y, x) = sum_{y'<y} C[y'][x - y + y'],      D(y, x) = D(y-1, x-1) + C[y-1][x-1],
// so A is a running sum along each anti-diagonal (starting from A(y, W) =
// ii[y][W]) and D along each diagonal (starting from D(y, 0) = 0): one
// thread per diagonal, no border cases, no padding, no scratch.
//
// Window evaluation and exactness rules: dense_eval.cuh.
//
// What bounds it: shared-memory reads and integer adds. A level moves
// little device memory (a 181x102 level: 18.5 KB of pixels in; in the
// tilted form 150 KB of tables out per frame), while every strided window
// reads 4 corners per rect of up to 46 weak trees from shared memory. The
// tables of a whole tilted level (12 B per element) or of a strip (8 B)
// fill one block's opt-in shared memory (at most 232,448 B), so one block
// runs per SM; B = 64 frames give 64 blocks per tilted level and
// 64 x n_strips blocks per strip level.

#include <cuda_runtime.h>

#include <cstdint>

#include "dense_eval.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kTilted>
__global__ void __launch_bounds__(kThreads)
dense_level_kernel(const uint8_t* __restrict__ img, int sh, int sw, int step,
                   int nx, int ny, int strip_gy, int win_h,
                   DENSE_CASCADE_PARAMS,
                   uint32_t* __restrict__ ii_out,
                   uint32_t* __restrict__ iit_out,
                   float* __restrict__ vnf_out,
                   uint8_t* __restrict__ alive_out) {
  extern __shared__ uint32_t smem[];
  const int s = blockIdx.x, b = blockIdx.y;
  const int row0 = s * strip_gy;
  const int rows = min(strip_gy + win_h - 1, sh - row0);  // level rows here
  const int w1 = sw + 1, n1 = (rows + 1) * w1;
  uint32_t* ii = smem;
  uint32_t* sq = smem + n1;
  uint32_t* iit = sq + n1;  // tilted form only
  const uint8_t* src =
      img + static_cast<size_t>(b) * sh * sw + static_cast<size_t>(row0) * sw;

  // 1. zero top row and left column; pixels (and their squares) at (y+1, x+1)
  for (int i = threadIdx.x; i < w1; i += blockDim.x) {
    ii[i] = 0u;
    sq[i] = 0u;
  }
  for (int y = threadIdx.x; y < rows; y += blockDim.x) {
    ii[(y + 1) * w1] = 0u;
    sq[(y + 1) * w1] = 0u;
  }
  for (int i = threadIdx.x; i < rows * sw; i += blockDim.x) {
    const int y = i / sw, x = i - y * sw;
    const uint32_t p = src[i];
    ii[(y + 1) * w1 + x + 1] = p;
    sq[(y + 1) * w1 + x + 1] = p * p;
  }
  __syncthreads();

  // 2. sum and squared-sum tables (uint32 wraparound)
  dense::prefix_tables(ii, sq, rows, sw);

  if (kTilted) {
    // 3. tilted table: A along anti-diagonals x + y = d ...
    for (int d = threadIdx.x; d <= sw + rows; d += blockDim.x) {
      int y = max(0, d - sw), x = d - y;
      uint32_t a = (y == 0) ? 0u : ii[y * w1 + sw];
      iit[y * w1 + x] = a;
      while (y < rows && x > 0) {
        a += ii[(y + 1) * w1 + x - 1] - ii[y * w1 + x - 1];
        ++y;
        --x;
        iit[y * w1 + x] = a;
      }
    }
    __syncthreads();
    // ... minus D along diagonals x - y = t - rows
    for (int t = threadIdx.x; t <= sw + rows; t += blockDim.x) {
      int y = max(0, rows - t), x = t - rows + y;
      uint32_t dsum = 0u;
      while (y < rows && x < sw) {
        dsum += ii[(y + 1) * w1 + x] - ii[y * w1 + x];
        ++y;
        ++x;
        iit[y * w1 + x] -= dsum;
      }
    }
    __syncthreads();
    // the whole level is one strip: emit the sum and tilted tables
    uint32_t* ii_g = ii_out + static_cast<size_t>(b) * n1;
    uint32_t* iit_g = iit_out + static_cast<size_t>(b) * n1;
    for (int i = threadIdx.x; i < n1; i += blockDim.x) {
      ii_g[i] = ii[i];
      iit_g[i] = iit[i];
    }
  }

  // 4. one thread per strided window whose origin row lies in this strip
  const int iy0 = row0 / step;
  const int iy1 = min(ny, (row0 + strip_gy) / step);
  const int n_win = (iy1 - iy0) * nx;
  for (int w = threadIdx.x; w < n_win; w += blockDim.x) {
    const int iy = iy0 + w / nx, ix = w % nx;
    const int origin = (iy * step - row0) * w1 + ix * step;
    float vnf;
    const bool alive = dense::eval_window<kTilted>(
        ii + origin, sq + origin, iit + origin, w1, DENSE_CASCADE_ARGS, &vnf);
    const size_t o = (static_cast<size_t>(b) * ny + iy) * nx + ix;
    vnf_out[o] = vnf;
    alive_out[o] = alive ? 1 : 0;
  }
}

template <bool kTilted>
int launch(int device, cudaStream_t stream, const uint8_t* img, int B, int sh,
           int sw, int step, int nx, int ny, int strip_gy, int n_strips,
           int win_h, DENSE_CASCADE_PARAMS, int smem_bytes, uint32_t* ii_out,
           uint32_t* iit_out, float* vnf_out, uint8_t* alive_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dense_level_kernel<kTilted>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_strips, B);
  dense_level_kernel<kTilted><<<grid, kThreads, smem_bytes, stream>>>(
      img, sh, sw, step, nx, ny, strip_gy, win_h, DENSE_CASCADE_ARGS, ii_out,
      iit_out, vnf_out, alive_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one block per (strip, frame) on `stream`; `tilted` selects the
// tilted form (n_strips must then be 1, and ii_out/iit_out receive the
// tables). Returns the CUDA error code of the attribute call or of the
// launch (0 on success).
extern "C" int dense_level_launch(
    int device, void* stream, int tilted, const uint8_t* img, int B, int sh,
    int sw, int step, int nx, int ny, int strip_gy, int n_strips, int win_h,
    DENSE_CASCADE_PARAMS, int smem_bytes, uint32_t* ii_out, uint32_t* iit_out,
    float* vnf_out, uint8_t* alive_out) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tilted) {
    return launch<true>(device, st, img, B, sh, sw, step, nx, ny, strip_gy,
                        n_strips, win_h, DENSE_CASCADE_ARGS, smem_bytes,
                        ii_out, iit_out, vnf_out, alive_out);
  }
  return launch<false>(device, st, img, B, sh, sw, step, nx, ny, strip_gy,
                       n_strips, win_h, DENSE_CASCADE_ARGS, smem_bytes, ii_out,
                       iit_out, vnf_out, alive_out);
}

extern "C" const char* dense_level_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
