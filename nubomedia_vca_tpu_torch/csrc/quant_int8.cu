// Dynamic per-tensor symmetric int8 quantization, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels quantize_int8_pallas (body _quant_kernel) and
// quantize_int8_stochastic_pallas (body _quant_kernel_stochastic) of
// nubomedia_vca_tpu/ops/pallas/quant_pallas.py (:73 and :100, pallas_call
// :83 and :110). For float32 x of n elements:
//   scale = max(max|x|, 1e-8) * float32(1/127)   (XLA's form of the / 127)
//   deterministic: q = clip(rint(x / scale), -127, 127)
//   stochastic:    q = clip(floor(clip(x / scale, -127, 127) + u), ±127)
// with u the top 24 bits of Philox4x32-10 word i % 4 at counter
// (i / 4, 0, 0, 0), key (seed, 0), times 2^-24: the plain PyTorch version
// (ops/quant.py) draws the same bits, so kernel and plain version agree bit
// for bit. The TPU's PRNG stream cannot be reproduced on any other device.
//
// What bounds it: device memory. x is read (4 B an element) and q written
// (1 B); its operations (an abs, a max, a division, a round, or the ten
// Philox rounds per 4 elements) are below the card's rate, but the
// division's slow path for a zero dividend is not: skipping it for the
// zeros of the ReLU outputs took the seven calls of an int8 forward from
// 220 to 174 us of kernel time on an H100. A small input is bound by a
// launch's latency and the barrier (11.5 us for 2.5M elements).
//
// The TPU kernel reads x once from VMEM into one block. Here one call is one
// cooperative launch of quant_kernel over every SM, with a grid-wide barrier
// between the maximum and the quantizing pass:
//   1. each thread loads the first kRegGroups groups of 4 elements of its
//      slice (group k * T + t for thread t of T) and keeps them in
//      registers, then streams the rest of its slice (groups kRegGroups * T
//      + t + i * T) for the maximum; a block reduces with warp shuffles and
//      does one atomicMax on the call's epoch-tagged slot,
//      (epoch << 32) | bits of |x|: the bits of a non-negative float order
//      as the float, a NaN stays above every number, and a slot from an
//      earlier call is below every value of this one, so the slot is never
//      cleared (the wrapper zeroes it once when the 32-bit epoch wraps);
//   2. after the barrier every thread reads the maximum, derives the scale,
//      quantizes the streamed groups again in the reverse order of pass 1,
//      so that the lines it read last may still be in the 50 MB L2, and then
//      the groups held in registers, which it does not read again. A
//      thread holds kRegGroups * 16 B of x: at 8 groups (80 registers, 768
//      resident threads an SM) 13 MB of x stays on the SMs between the
//      passes, and a layer input of up to 3.2M elements is read from device
//      memory once. On an H100 this saved no device time over two launches
//      with the same slot and a reverse second pass (173.8 against 174.7 us
//      over the seven calls), nor did 1, 2 or 4 groups differ by more than
//      2% (16 groups: +11%); the one launch spares the host the second
//      launch.
// A group's index is its Philox counter, so no ordering changes a bit; the
// maximum does not depend on order either. Division and rounding are
// spelled out (__fdiv_rn, __float2int_rn, __fadd_rn), and the build uses
// -fmad=false and no fast math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRegGroups = 8;  // groups of 4 elements a thread keeps
constexpr int kUnroll = 4;     // loads in flight a thread in a streamed pass
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned warp_max(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

__device__ __forceinline__ unsigned group_max(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)),
             max(abs_bits(v.z), abs_bits(v.w)));
}

// Group g of x: elements 4g .. 4g + 3, one 16-byte load where x is 16-byte
// aligned and the group is whole; elements past n read as 0.
__device__ __forceinline__ float4 load_group(const float* __restrict__ x,
                                             long long g, long long n,
                                             bool vec) {
  const long long i0 = 4 * g;
  if (vec && i0 + 3 < n) return reinterpret_cast<const float4*>(x)[g];
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i0 < n) v.x = x[i0];
  if (i0 + 1 < n) v.y = x[i0 + 1];
  if (i0 + 2 < n) v.z = x[i0 + 2];
  if (i0 + 3 < n) v.w = x[i0 + 3];
  return v;
}

// max(abs_max, 1e-8) / 127 as XLA compiles it, a multiply by the float32
// reciprocal of 127; a NaN maximum stays NaN, as in the plain version
__device__ __forceinline__ float scale_of(unsigned amax_bits) {
  const float a = __uint_as_float(amax_bits);
  return __fmul_rn(a < 1e-8f ? 1e-8f : a, 1.0f / 127.0f);
}

// v / scale, correctly rounded. A zero v skips the division: 0 / scale is
// a zero, which rounds and floors as the quotient would, and six of the
// seven layer inputs are ReLU outputs, many of them zero.
__device__ __forceinline__ float quotient(float v, float scale) {
  return v == 0.0f ? v : __fdiv_rn(v, scale);
}

__device__ __forceinline__ int8_t quant_rint(float v, float scale) {
  const int r = __float2int_rn(quotient(v, scale));
  return static_cast<int8_t>(min(max(r, -127), 127));
}

__device__ __forceinline__ int8_t quant_floor(float v, float scale,
                                              unsigned bits) {
  const float s = fminf(fmaxf(quotient(v, scale), -127.0f), 127.0f);
  const float u = __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-8f);
  const float f = floorf(__fadd_rn(s, u));
  return static_cast<int8_t>(fminf(fmaxf(f, -127.0f), 127.0f));
}

// Philox4x32-10 (Salmon, Moraes, Dror, Shaw, SC'11): ten rounds of two
// 32x32->64 multiplies, the key bumped by the Weyl constants between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Quantizes group g (its values v) into q; vec: q is 4-byte aligned.
__device__ __forceinline__ void store_group(int8_t* __restrict__ q,
                                            long long g, long long n,
                                            bool vec, float4 v, float scale,
                                            bool stochastic, unsigned seed) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (stochastic)
    w = philox4x32_10(make_uint4(static_cast<unsigned>(g), 0u, 0u, 0u), seed,
                      0u);
  const char4 o =
      stochastic
          ? make_char4(quant_floor(v.x, scale, w.x),
                       quant_floor(v.y, scale, w.y),
                       quant_floor(v.z, scale, w.z),
                       quant_floor(v.w, scale, w.w))
          : make_char4(quant_rint(v.x, scale), quant_rint(v.y, scale),
                       quant_rint(v.z, scale), quant_rint(v.w, scale));
  const long long i0 = 4 * g;
  if (vec && i0 + 3 < n) {
    reinterpret_cast<char4*>(q)[g] = o;
    return;
  }
  const int8_t os[4] = {o.x, o.y, o.z, o.w};
  for (int j = 0; j < 4 && i0 + j < n; ++j) q[i0 + j] = os[j];
}

// Block maximum of m, then one atomicMax of (epoch << 32) | max on slot.
__device__ __forceinline__ void publish_max(unsigned m,
                                            unsigned long long* slot,
                                            unsigned epoch) {
  __shared__ unsigned part[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  m = warp_max(m);
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = warp_max(lane < kThreads / 32 ? part[lane] : 0u);
    if (lane == 0)
      atomicMax(slot, (static_cast<unsigned long long>(epoch) << 32) | m);
  }
}

// The maximum of |x| over groups first, first + T, ... below n_groups, with
// kUnroll loads in flight; *last gets the last of them (first - T if none).
__device__ __forceinline__ unsigned stream_max(const float* __restrict__ x,
                                               long long n, bool vec,
                                               long long first,
                                               long long n_groups,
                                               long long T, long long* last) {
  unsigned m = 0u;
  long long g = first;
  for (; g + (kUnroll - 1) * T < n_groups; g += kUnroll * T) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load_group(x, g + u * T, n, vec);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m = max(m, group_max(v[u]));
  }
  for (; g < n_groups; g += T) m = max(m, group_max(load_group(x, g, n, vec)));
  *last = g - T;
  return m;
}

// Quantizes groups last, last - T, ... down to first, with kUnroll loads in
// flight.
__device__ __forceinline__ void stream_quantize(
    const float* __restrict__ x, int8_t* __restrict__ q, long long n,
    bool vec, long long first, long long last, long long T, float scale,
    bool stochastic, unsigned seed) {
  long long g = last;
  for (; g - (kUnroll - 1) * T >= first; g -= kUnroll * T) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load_group(x, g - u * T, n, vec);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      store_group(q, g - u * T, n, vec, v[u], scale, stochastic, seed);
  }
  for (; g >= first; g -= T)
    store_group(q, g, n, vec, load_group(x, g, n, vec), scale, stochastic,
                seed);
}

// One cooperative launch of T = gridDim.x * kThreads threads (see the top
// of the file); vec: x is 16-byte and q 4-byte aligned.
template <int kK>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const float* __restrict__ x, long long n, int vec,
             unsigned long long* slot, unsigned epoch, int stochastic,
             unsigned seed, int8_t* __restrict__ q,
             float* __restrict__ scale_out) {
  const long long T = static_cast<long long>(gridDim.x) * kThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long n_groups = (n + 3) / 4;
  float4 keep[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const long long g = k * T + t;
    keep[k] = g < n_groups ? load_group(x, g, n, vec)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const long long first = kK * T + t;  // this thread's streamed groups
  long long last;
  unsigned m = stream_max(x, n, vec, first, n_groups, T, &last);
#pragma unroll
  for (int k = 0; k < kK; ++k) m = max(m, group_max(keep[k]));
  publish_max(m, slot, epoch);

  cg::this_grid().sync();

  const float scale = scale_of(static_cast<unsigned>(__ldcg(slot)));
  if (t == 0) *scale_out = scale;
  stream_quantize(x, q, n, vec, first, last, T, scale, stochastic, seed);
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const long long g = k * T + t;
    if (g < n_groups)
      store_group(q, g, n, vec, keep[k], scale, stochastic, seed);
  }
}

}  // namespace

// The most blocks of quant_kernel that the device runs at once (its SMs
// times the blocks an SM holds), the grid's upper bound; the wrapper asks
// once per device. Returns the CUDA error code (0 on success).
extern "C" int quant_int8_max_blocks(int device, int* blocks) {
  int n_sm = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, quant_kernel<kRegGroups>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = n_sm * per_sm;
  return 0;
}

// Quantizes x[0..n) into q and *scale_out on `stream` with `blocks` blocks
// (at most quant_int8_max_blocks); slot is the stream's 64-bit maximum slot
// and epoch this call's tag (never 0, above the last call's). Returns the
// CUDA error code of the launch (0 on success).
extern "C" int quant_int8_launch(int device, void* stream, const float* x,
                                 long long n, int stochastic, unsigned seed,
                                 int blocks, unsigned long long* slot,
                                 unsigned epoch, int8_t* q,
                                 float* scale_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(q) % 4 == 0);
  void* args[] = {&x, &n, &vec, &slot, &epoch, &stochastic, &seed, &q,
                  &scale_out};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(quant_kernel<kRegGroups>), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

extern "C" const char* quant_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
