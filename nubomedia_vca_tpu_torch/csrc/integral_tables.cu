// Sum and squared-sum integral tables in one pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel integral_images_pallas
// (nubomedia_vca_tpu/ops/pallas/integral_pallas.py:52, pallas_call :59):
// [B,H,W] u8 -> ii, sq [B,H+1,W+1] int32 with a zero top row and left
// column, uint32 wraparound arithmetic (the int32 bit patterns of
// ops/integral.py's integral_image and sq_integral_image).
//
// What bounds it: device memory. A 320x180 level brings 57.6 KB in and
// writes 2 x 232 KB of tables per frame, with 2 adds and a multiply per
// pixel; at B = 64 that is about 9 us of bytes. A level is small, so the
// design is about latency: enough blocks in flight, no thread walking a
// long serial chain, each word moved once.
//
// Single pass with a decoupled look-back. One block per band of
// `band_rows` image rows of one frame (at 320x180, 16 rows: 12 bands a
// frame, 768 blocks at B = 64, several per SM):
//   1. a block takes a ticket (atomicAdd); ticket t is band t % n_bands of
//      frame t / n_bands, so the bands above it hold smaller tickets and
//      are already running: it never waits on a block that has not been
//      scheduled;
//   2. it reads its band's pixels once (the band's rows are contiguous) into
//      shared memory, scans each row with warp shuffles (4 pixels a lane,
//      an inclusive warp scan of the lane sums, a carry between 128-pixel
//      chunks) and builds the in-band column prefix in shared memory (one
//      thread per column, band_rows steps); the band's last row is then
//      its column aggregate;
//   3. unless it is the frame's last band, it publishes that aggregate and
//      a flag; then it looks back over the bands above: one thread per band
//      waits for that band's flag, the nearest band whose inclusive prefix
//      is published ends the walk, and the carry is that prefix plus the
//      aggregates of the bands between, summed per column from independent
//      loads (one round trip, not one per band); it publishes its own
//      inclusive prefix (carry + aggregate) with a second flag. Flags carry
//      the call's epoch, so the wrapper reuses its scratch without clearing
//      it;
//   4. it writes its rows of both tables (carry + in-band prefix, and the
//      zero column; the first band also the zero row), each word once,
//      neighbouring threads on neighbouring addresses.
// Published vectors are read through L2 (__ldcg): L1 is not coherent
// between SMs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kAggregate = 1u, kInclusive = 2u;  // flag states

__device__ __forceinline__ void publish(uint32_t* flag, uint32_t value) {
  __threadfence();  // the vector before the flag
  __syncthreads();
  if (threadIdx.x == 0) atomicExch(flag, value);
}

__global__ void __launch_bounds__(kThreads)
integral_bands_kernel(const uint8_t* __restrict__ img, int H, int W,
                      int band_rows, int n_bands, int pitch,
                      uint32_t* __restrict__ ii_out,
                      uint32_t* __restrict__ sq_out, uint32_t* ticket,
                      uint32_t ticket_base, uint32_t* flags, uint32_t* agg,
                      uint32_t* incl, uint32_t epoch) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_ii = smem;                        // [band_rows][pitch]
  uint32_t* s_sq = s_ii + band_rows * pitch;
  uint32_t* c_ii = s_sq + band_rows * pitch;    // carry from above, [W]
  uint32_t* c_sq = c_ii + pitch;
  uint8_t* s_px = reinterpret_cast<uint8_t*>(c_sq + pitch);  // [rows][W]
  __shared__ uint32_t s_ticket;
  __shared__ int s_near;  // distance - 1 to the nearest inclusive prefix

  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1u) - ticket_base;
  __syncthreads();
  const uint32_t slot = s_ticket;
  const int b = static_cast<int>(slot / n_bands);
  const int band = static_cast<int>(slot) - b * n_bands;
  const int row0 = band * band_rows;
  const int rows = max(0, min(band_rows, H - row0));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 1. the band's pixels, once
  const uint8_t* src = img + (static_cast<size_t>(b) * H + row0) * W;
  for (int i = threadIdx.x; i < rows * W; i += kThreads) s_px[i] = src[i];
  __syncthreads();

  // 2. row prefixes (4 pixels a lane, warp scan of the lane sums)
  for (int r = warp; r < rows; r += kWarps) {
    const uint8_t* px = s_px + r * W;
    uint32_t* oi = s_ii + r * pitch;
    uint32_t* oq = s_sq + r * pitch;
    uint32_t ci = 0u, cq = 0u;
    for (int x0 = 0; x0 < W; x0 += 128) {
      const int x = x0 + 4 * lane;
      uint32_t a[4], q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t p = (x + k < W) ? px[x + k] : 0u;
        a[k] = (k ? a[k - 1] : 0u) + p;
        q[k] = (k ? q[k - 1] : 0u) + p * p;
      }
      uint32_t ti = a[3], tq = q[3];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t ni = __shfl_up_sync(kFull, ti, o);
        const uint32_t nq = __shfl_up_sync(kFull, tq, o);
        if (lane >= o) {
          ti += ni;
          tq += nq;
        }
      }
      const uint32_t ei = ci + ti - a[3], eq = cq + tq - q[3];
      if (x < W) {  // x + 3 < pitch: pitch is W rounded up to 4
        *reinterpret_cast<uint4*>(oi + x) =
            make_uint4(ei + a[0], ei + a[1], ei + a[2], ei + a[3]);
        *reinterpret_cast<uint4*>(oq + x) =
            make_uint4(eq + q[0], eq + q[1], eq + q[2], eq + q[3]);
      }
      ci += __shfl_sync(kFull, ti, 31);
      cq += __shfl_sync(kFull, tq, 31);
    }
  }
  __syncthreads();
  // in-band column prefix; then row rows-1 is the band's aggregate
  for (int x = threadIdx.x; x < W; x += kThreads) {
    uint32_t ai = 0u, aq = 0u;
    c_ii[x] = 0u;
    c_sq[x] = 0u;
    for (int r = 0; r < rows; ++r) {
      ai += s_ii[r * pitch + x];
      s_ii[r * pitch + x] = ai;
      aq += s_sq[r * pitch + x];
      s_sq[r * pitch + x] = aq;
    }
  }
  __syncthreads();

  // 3. decoupled look-back over the bands above: one thread per band above
  //    waits for its flag, and the nearest band with a published inclusive
  //    prefix ends the walk; then each thread sums, for its columns, that
  //    prefix and the aggregates of the bands between (independent loads)
  const size_t vec = 2 * static_cast<size_t>(W);  // ii, then sq
  const uint32_t* last_i = s_ii + (rows - 1) * pitch;
  const uint32_t* last_q = s_sq + (rows - 1) * pitch;
  const bool has_next = band + 1 < n_bands;
  if (band > 0) {
    if (has_next) {
      uint32_t* v = agg + slot * vec;
      for (int x = threadIdx.x; x < W; x += kThreads) {
        __stcg(v + x, last_i[x]);
        __stcg(v + W + x, last_q[x]);
      }
      publish(flags + slot, (epoch << 2) | kAggregate);
    }
    if (threadIdx.x == 0) s_near = band - 1;  // band 0: always inclusive
    __syncthreads();
    for (int t = threadIdx.x; t < band; t += kThreads) {
      const volatile uint32_t* f = flags + (slot - 1 - t);
      uint32_t s = *f;
      while ((s >> 2) != epoch) {
        __nanosleep(32);
        s = *f;
      }
      if ((s & 3u) == kInclusive) atomicMin(&s_near, t);
    }
    __syncthreads();
    __threadfence();
    const int near = s_near;
    const uint32_t* v = incl + (slot - 1 - near) * vec;
    for (int x = threadIdx.x; x < W; x += kThreads) {
      uint32_t ci = __ldcg(v + x), cq = __ldcg(v + W + x);
      for (int t = 0; t < near; ++t) {
        const uint32_t* a = agg + (slot - 1 - t) * vec;
        ci += __ldcg(a + x);
        cq += __ldcg(a + W + x);
      }
      c_ii[x] = ci;
      c_sq[x] = cq;
    }
  }
  if (has_next) {
    uint32_t* v = incl + slot * vec;
    for (int x = threadIdx.x; x < W; x += kThreads) {
      __stcg(v + x, c_ii[x] + last_i[x]);
      __stcg(v + W + x, c_sq[x] + last_q[x]);
    }
    publish(flags + slot, (epoch << 2) | kInclusive);
  }
  __syncthreads();

  // 4. the band's table rows, each word once
  const int w1 = W + 1;
  uint32_t* ti = ii_out + static_cast<size_t>(b) * (H + 1) * w1;
  uint32_t* tq = sq_out + static_cast<size_t>(b) * (H + 1) * w1;
  if (band == 0) {
    for (int x = threadIdx.x; x < w1; x += kThreads) {
      ti[x] = 0u;
      tq[x] = 0u;
    }
  }
  uint32_t* di = ti + static_cast<size_t>(row0 + 1) * w1;
  uint32_t* dq = tq + static_cast<size_t>(row0 + 1) * w1;
  // (r, x) of element i, stepped without a division
  const int dr = kThreads / w1, dx = kThreads - dr * w1;
  int r = threadIdx.x / w1, x = threadIdx.x - r * w1;
  for (int i = threadIdx.x; i < rows * w1; i += kThreads) {
    uint32_t vi = 0u, vq = 0u;
    if (x > 0) {
      vi = c_ii[x - 1] + s_ii[r * pitch + x - 1];
      vq = c_sq[x - 1] + s_sq[r * pitch + x - 1];
    }
    di[i] = vi;
    dq[i] = vq;
    r += dr;
    x += dx;
    if (x >= w1) {
      x -= w1;
      ++r;
    }
  }
}

}  // namespace

// Launches B * n_bands blocks on `stream`. `ticket` must hold ticket_base
// (the wrapper counts the tickets it has issued); `flags` [B * n_bands]
// must hold no word of this `epoch` (1 .. 2^30 - 1); `agg` and `incl` hold
// 2 * W words per band. Returns the CUDA error code of the attribute call
// or of the launch (0 on success).
extern "C" int integral_tables_launch(int device, void* stream,
                                      const uint8_t* img, int B, int H, int W,
                                      int band_rows, int n_bands, int pitch,
                                      int smem_bytes, uint32_t* ii_out,
                                      uint32_t* sq_out, uint32_t* ticket,
                                      unsigned ticket_base, uint32_t* flags,
                                      uint32_t* agg, uint32_t* incl,
                                      unsigned epoch) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_bytes > 48 * 1024) {  // above the default: opt in
    err = cudaFuncSetAttribute(integral_bands_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  integral_bands_kernel<<<B * n_bands, kThreads, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      img, H, W, band_rows, n_bands, pitch, ii_out, sq_out, ticket,
      ticket_base, flags, agg, incl, epoch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* integral_tables_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
