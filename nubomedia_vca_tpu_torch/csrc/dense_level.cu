// Dense phase of one pre-resized tilted pyramid level, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel build_dense_phase
// (nubomedia_vca_tpu/ops/pallas/dense_pallas.py:221) in its tilted form
// (the single-block kernel, pallas_call :329, with the in-kernel rotated
// table, :181), in two kernels after the sum and squared-sum tables
// (csrc/integral_tables.cu); its row-strip form is a band of the pyramid
// kernel (pyramid_dense.cu):
//   - tilted_table_kernel builds the tilted table from the sum table in
//     device memory;
//   - tilted_eval_kernel evaluates the dense block tile by tile: a block
//     stages one tile's window of the three tables into shared memory and
//     evaluates the tile's strided windows there.
//   The TPU kernel holds the whole level in VMEM; on Hopper that bound the
//   level to 232,448 B of shared memory (12 B per table element, 181x102
//   at most) and allowed one block per SM. Here shared memory is sized by
//   the tile, so every level of a tilted cascade takes these kernels and
//   a 320x180 level at B = 64 gives 3,840 blocks, several per SM.
//
// The tilted table, T(y, x) = sum of pixels (y', x') with y' < y and
// |x' - (x - 1)| <= y - y' - 1, comes from the sum table: with
// C[y'][j] = ii[y'+1][j] - ii[y'][j] the exclusive prefix of pixel row y'
// (j clamped to [0, W]),
//   T(y, x) = A(y, x) - D(y, x),
//   A(y, x) = sum_{y'<y} C[y'][x + y - 1 - y'],  A(y, x) = A(y-1, x+1) + C[y-1][x],
//   D(y, x) = sum_{y'<y} C[y'][x - y + y'],      D(y, x) = D(y-1, x-1) + C[y-1][x-1],
// with A(y-1, W+1) = ii[y-1][W] and D(y, 0) = 0 at the borders.
// tilted_table_kernel runs them along the diagonals, one block per frame:
// first one thread per anti-diagonal x + y = d carries A down the rows and
// writes it, then, after one barrier, one thread per diagonal x - y carries
// D and subtracts it. All threads of a warp step the same row, where their
// diagonals cross consecutive columns, so every read of ii and every write
// of the table is coalesced, and no thread waits for another within a pass.
// A thread loads kChunk rows ahead before it updates its running sum (the
// loads do not depend on it), so that many loads are in flight. The other
// form, row by row with one thread per column, needs the neighbour's value
// of the previous row, hence a barrier per row, which this form avoids.
//
// Window evaluation: a tile is up to tile_ny x tile_nx strided windows, one
// thread each; its block stages rows [iy0*step, (iy0 + n_rows - 1)*step +
// h0] and the matching columns of ii, sq and iit at a fixed row length
// `pitch` (a full tile's width) with 4-byte cp.async (a table row's pitch,
// 4 (W + 1) B, is not 16-byte aligned, which TMA would need), and copies
// the cascade's tree records (dense_cuda.py, tile_records) into
// shared memory beside them. A record holds each feature's corner offsets
// for that pitch, so a rect is 4 shared-memory reads at precomputed
// offsets. Every window reads the same records (warp-uniform); read from
// device memory through L1, these dependent loads took a third of the
// evaluation's time on an H100. The evaluator is dense_eval.cuh's
// eval_records with tilted features, which the pyramid kernel shares
// without them (norm_window, then per weak tree __fmul_rn / __fadd_rn,
// compare, stage sums, early exit).
// Compacting the survivors of stage 0 (a warp ballot into a shared list,
// so that warps stay full as windows die) gained at most 5% and lost 3% on
// the largest levels: a block then keeps fewer warps in flight to hide the
// latency of its dependent reads.
// Tensor cores have no place here: the dense block is one to three
// 4-corner sums per feature of each weak tree, with early exit, not a
// matrix product.
//
// What bounds it: for the tables, device memory (a 320x180 level writes
// 232 KB per table and frame and reads the sum table once more); for the
// evaluation, shared-memory reads and integer adds (4 reads per rect of up
// to 46 weak trees per live window).

#include <cuda_runtime.h>

#include <cstdint>

#include "dense_eval.cuh"

namespace {

constexpr int kEvalThreads = 256;   // one thread per window of a full tile
constexpr int kTableThreads = 512;  // diagonals in flight per frame
constexpr int kChunk = 8;           // rows a table thread loads ahead

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---------------------------------------------------------- tilted table
__global__ void __launch_bounds__(kTableThreads)
tilted_table_kernel(const uint32_t* __restrict__ ii_in, int H, int W,
                    uint32_t* __restrict__ iit_out) {
  const int w1 = W + 1, n_diag = W + H + 1;
  const uint32_t* src = ii_in + static_cast<size_t>(blockIdx.x) * (H + 1) * w1;
  uint32_t* dst = iit_out + static_cast<size_t>(blockIdx.x) * (H + 1) * w1;
  for (int x = threadIdx.x; x < w1; x += blockDim.x) dst[x] = 0u;  // T(0, x)

  // A along the anti-diagonal d = x + y: from A(0, d) = 0 (d <= W) or
  // A(d - W, W) = ii[d - W][W]
  for (int d = threadIdx.x; d < n_diag; d += blockDim.x) {
    uint32_t a = 0u;
    for (int y0 = 1; y0 <= H && d - y0 >= 0; y0 += kChunk) {
      uint32_t cur[kChunk], prev[kChunk];  // ii[y][x], ii[y-1][x]
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int y = y0 + j, x = d - y;
        const bool in = y <= H && x >= 0 && x <= W;
        cur[j] = in ? src[y * w1 + x] : 0u;
        prev[j] = (in && x < W) ? src[(y - 1) * w1 + x] : 0u;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int y = y0 + j, x = d - y;
        if (y <= H && x >= 0 && x <= W) {
          a = (x == W) ? cur[j] : a + cur[j] - prev[j];
          dst[y * w1 + x] = a;
        }
      }
    }
  }
  __syncthreads();  // the block's writes of A are visible to the block

  // minus D along the diagonal t = x - y + H, from D(y, 0) = 0
  for (int t = threadIdx.x; t < n_diag; t += blockDim.x) {
    uint32_t dsum = 0u;
    for (int y0 = 1; y0 <= H && t - H + y0 <= W; y0 += kChunk) {
      uint32_t cur[kChunk], prev[kChunk], a[kChunk];  // ii at x - 1; A
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int y = y0 + j, x = t - H + y;
        const bool in = y <= H && x >= 1 && x <= W;
        cur[j] = in ? src[y * w1 + x - 1] : 0u;
        prev[j] = in ? src[(y - 1) * w1 + x - 1] : 0u;
        a[j] = in ? dst[y * w1 + x] : 0u;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int y = y0 + j, x = t - H + y;
        if (y <= H && x >= 1 && x <= W) {
          dsum += cur[j] - prev[j];
          dst[y * w1 + x] = a[j] - dsum;
        }
      }
    }
  }
}

// --------------------------------------------------------- tiled evaluation
// The tree records (dense_eval.cuh, eval_records) carry corner offsets for
// a staged tile of row length `pitch`.
using dense::kTreeWords;

__global__ void __launch_bounds__(kEvalThreads)
tilted_eval_kernel(const uint32_t* __restrict__ ii,
                   const uint32_t* __restrict__ sq,
                   const uint32_t* __restrict__ iit, int sh, int sw, int step,
                   int nx, int ny, int tile_ny, int tile_nx, int n_tiles_x,
                   int win_h, int win_w, int tile_rows, int pitch,
                   const int* __restrict__ trees, int n_weak,
                   const float* __restrict__ stage_thr, int n_stages,
                   int norm_w, int norm_h, float norm_area, float var_thr,
                   float* __restrict__ vnf_out,
                   uint8_t* __restrict__ alive_out) {
  extern __shared__ uint32_t smem[];
  const int t = blockIdx.x, b = blockIdx.y;
  const int ty = t / n_tiles_x, tx = t - ty * n_tiles_x;
  const int iy0 = ty * tile_ny, ix0 = tx * tile_nx;
  const int n_rows = min(tile_ny, ny - iy0), n_cols = min(tile_nx, nx - ix0);
  const int rows = (n_rows - 1) * step + win_h + 1;  // staged table rows
  const int cols = (n_cols - 1) * step + win_w + 1;  // staged table columns
  const int w1 = sw + 1, n = tile_rows * pitch;
  uint32_t* s_ii = smem;
  uint32_t* s_sq = smem + n;
  uint32_t* s_iit = s_sq + n;
  int* s_trees = reinterpret_cast<int*>(s_iit + n);
  float* s_thr = reinterpret_cast<float*>(s_trees + n_weak * kTreeWords);

  // the tile's window of the three tables, one warp per row
  const size_t base = static_cast<size_t>(b) * (sh + 1) * w1 +
                      static_cast<size_t>(iy0 * step) * w1 + ix0 * step;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    for (int c = lane; c < cols; c += 32) {
      const size_t src = base + static_cast<size_t>(r) * w1 + c;
      const int dst = r * pitch + c;
      cp_async4(s_ii + dst, ii + src);
      cp_async4(s_sq + dst, sq + src);
      cp_async4(s_iit + dst, iit + src);
    }
  }
  cp_async_commit();
  dense::stage_records(s_trees, trees, n_weak, s_thr, stage_thr, n_stages);
  cp_async_wait<0>();
  __syncthreads();

  for (int w = threadIdx.x; w < n_rows * n_cols; w += blockDim.x) {
    const int r = w / n_cols, c = w - r * n_cols;
    const int origin = r * step * pitch + c * step;
    const dense::Window win = dense::eval_records<true>(
        s_trees, n_weak, s_thr, n_stages, s_ii + origin, s_sq + origin,
        s_iit + origin, pitch, norm_w, norm_h, norm_area, var_thr);
    const size_t o = (static_cast<size_t>(b) * ny + iy0 + r) * nx + ix0 + c;
    vnf_out[o] = win.vnf;
    alive_out[o] = win.alive ? 1 : 0;
  }
}

int set_smem(const void* kernel, int smem_bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
}

}  // namespace

// Every launcher runs on `stream` and returns the CUDA error code of the
// attribute call or of the launch (0 on success).

// One block per frame: the tilted table [B, H+1, W+1] from the sum table of
// the same shape.
extern "C" int tilted_table_launch(int device, void* stream,
                                   const uint32_t* ii, int B, int H, int W,
                                   uint32_t* iit_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  tilted_table_kernel<<<B, kTableThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(ii, H, W,
                                                             iit_out);
  return static_cast<int>(cudaGetLastError());
}

// One block per (tile, frame): vnf and alive of a tilted level from its
// sum, squared-sum and tilted tables and the cascade's tile records.
extern "C" int tilted_eval_launch(int device, void* stream,
                                  const uint32_t* ii, const uint32_t* sq,
                                  const uint32_t* iit, int B, int sh, int sw,
                                  int step, int nx, int ny, int tile_ny,
                                  int tile_nx, int n_tiles_y, int n_tiles_x,
                                  int win_h, int win_w, int tile_rows,
                                  int pitch, const int* trees, int n_weak,
                                  const float* stage_thr, int n_stages,
                                  int norm_w, int norm_h, float norm_area,
                                  float var_thr, int smem_bytes,
                                  float* vnf_out, uint8_t* alive_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = set_smem(reinterpret_cast<const void*>(tilted_eval_kernel),
                    smem_bytes);
  if (rc != 0) return rc;
  tilted_eval_kernel<<<dim3(n_tiles_y * n_tiles_x, B), kEvalThreads,
                       smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      ii, sq, iit, sh, sw, step, nx, ny, tile_ny, tile_nx, n_tiles_x, win_h,
      win_w, tile_rows, pitch, trees, n_weak, stage_thr, n_stages, norm_w,
      norm_h, norm_area, var_thr, vnf_out, alive_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dense_level_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
