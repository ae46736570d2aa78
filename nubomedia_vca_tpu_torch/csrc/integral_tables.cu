// Sum and squared-sum integral tables in one pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel integral_images_pallas
// (nubomedia_vca_tpu/ops/pallas/integral_pallas.py:52, pallas_call :59):
// [B,H,W] u8 -> ii, sq [B,H+1,W+1] int32 with a zero top row and left
// column, uint32 wraparound arithmetic (the int32 bit patterns of
// ops/integral.py's integral_image and sq_integral_image).
//
// One block per frame. Row pass: one warp per image row walks the row in
// 32-pixel chunks; each chunk is an inclusive warp scan (__shfl_up_sync)
// plus the running carry, so reads and writes are coalesced. Column pass:
// one thread per table column walks down the rows, neighbouring threads on
// neighbouring addresses. The row pass's results go through global memory
// (L2): __syncthreads() makes a block's global writes visible to the whole
// block.
//
// What bounds it: device memory. A 320x180 level brings 57.6 KB in and
// writes 2 x 232 KB of tables per frame; there are 2 adds and a multiply
// per pixel. The two tables together do not fit one block's shared memory
// at that size, hence the pass through L2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
integral_tables_kernel(const uint8_t* __restrict__ img, int H, int W,
                       uint32_t* __restrict__ ii_out,
                       uint32_t* __restrict__ sq_out) {
  const int b = blockIdx.x, w1 = W + 1;
  const uint8_t* src = img + static_cast<size_t>(b) * H * W;
  uint32_t* ii = ii_out + static_cast<size_t>(b) * (H + 1) * w1;
  uint32_t* sq = sq_out + static_cast<size_t>(b) * (H + 1) * w1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int x = threadIdx.x; x < w1; x += blockDim.x) {
    ii[x] = 0u;
    sq[x] = 0u;
  }
  // row pass: row y of the image -> row y+1 of the tables
  for (int y = warp; y < H; y += n_warps) {
    uint32_t* ri = ii + (y + 1) * w1;
    uint32_t* rq = sq + (y + 1) * w1;
    if (lane == 0) {
      ri[0] = 0u;
      rq[0] = 0u;
    }
    uint32_t carry_i = 0u, carry_q = 0u;
    for (int x0 = 0; x0 < W; x0 += 32) {
      const int x = x0 + lane;
      const uint32_t p = (x < W) ? src[y * W + x] : 0u;
      uint32_t a = p, q = p * p;
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t na = __shfl_up_sync(kFull, a, o);
        const uint32_t nq = __shfl_up_sync(kFull, q, o);
        if (lane >= o) {
          a += na;
          q += nq;
        }
      }
      if (x < W) {
        ri[x + 1] = carry_i + a;
        rq[x + 1] = carry_q + q;
      }
      carry_i += __shfl_sync(kFull, a, 31);
      carry_q += __shfl_sync(kFull, q, 31);
    }
  }
  __syncthreads();
  // column pass
  for (int x = 1 + threadIdx.x; x <= W; x += blockDim.x) {
    uint32_t a = 0u, c = 0u;
    for (int y = 1; y <= H; ++y) {
      const int k = y * w1 + x;
      a += ii[k];
      ii[k] = a;
      c += sq[k];
      sq[k] = c;
    }
  }
}

}  // namespace

// Launches one block per frame on `stream`. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int integral_tables_launch(int device, void* stream,
                                      const uint8_t* img, int B, int H, int W,
                                      uint32_t* ii_out, uint32_t* sq_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  integral_tables_kernel<<<B, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      img, H, W, ii_out, sq_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* integral_tables_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
