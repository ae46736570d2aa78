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
// The TPU kernel reads x once from VMEM into one block; on Hopper a tensor
// of millions of elements needs the whole card, and blocks cannot share a
// running maximum, so one call is two launches on the caller's stream with
// no host synchronisation between them:
//   1. absmax_kernel: a grid-stride reduction (16-byte loads where the
//      pointer allows), warp shuffles and shared memory per block, then one
//      atomicMax per block on the bits of |x| as unsigned, which orders
//      non-negative floats as the floats;
//   2. quantize_kernel: every thread reads the maximum from device memory,
//      derives the scale and writes its int8 values (4 per 16-byte load);
//      thread 0 of block 0 also writes the scale.
// Division and rounding are spelled out (__fdiv_rn, __float2int_rn,
// __fadd_rn), and the build uses -fmad=false and no fast math.
//
// What bounds it: device memory. Each element is read twice (4 B each) and
// written once (1 B); its operations (an abs, a max, a division, a round,
// or the ten Philox rounds per 4 elements) are far below the card's rate.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned warp_max(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ x, long long n, int vec,
              unsigned* __restrict__ amax_bits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long n_vec = vec ? n / 4 : 0;
  unsigned m = 0u;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (long long i = tid; i < n_vec; i += stride) {
    const float4 v = x4[i];
    m = max(m, max(max(abs_bits(v.x), abs_bits(v.y)),
                   max(abs_bits(v.z), abs_bits(v.w))));
  }
  for (long long i = 4 * n_vec + tid; i < n; i += stride)
    m = max(m, abs_bits(x[i]));
  __shared__ unsigned part[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  m = warp_max(m);
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = warp_max(lane < kThreads / 32 ? part[lane] : 0u);
    if (lane == 0 && m != 0u) atomicMax(amax_bits, m);
  }
}

// max(abs_max, 1e-8) / 127 as XLA compiles it, a multiply by the float32
// reciprocal of 127; a NaN maximum stays NaN, as in the plain version
__device__ __forceinline__ float scale_of(unsigned amax_bits) {
  const float a = __uint_as_float(amax_bits);
  return __fmul_rn(a < 1e-8f ? 1e-8f : a, 1.0f / 127.0f);
}

__device__ __forceinline__ int8_t quant_rint(float v, float scale) {
  const int r = __float2int_rn(__fdiv_rn(v, scale));
  return static_cast<int8_t>(min(max(r, -127), 127));
}

__device__ __forceinline__ int8_t quant_floor(float v, float scale,
                                              unsigned bits) {
  const float s = fminf(fmaxf(__fdiv_rn(v, scale), -127.0f), 127.0f);
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

// One thread per group of 4 elements (the group's index is its Philox
// counter); vec: x is 16-byte and q 4-byte aligned.
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, long long n, int vec,
                const unsigned* __restrict__ amax_bits, int stochastic,
                unsigned seed, int8_t* __restrict__ q,
                float* __restrict__ scale_out) {
  const float scale = scale_of(*amax_bits);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n_groups = (n + 3) / 4;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < n_groups; g += stride) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (stochastic)
      w = philox4x32_10(make_uint4(static_cast<unsigned>(g), 0u, 0u, 0u),
                        seed, 0u);
    const long long i0 = 4 * g;
    if (vec && i0 + 3 < n) {
      const float4 v = reinterpret_cast<const float4*>(x)[g];
      char4 o;
      if (stochastic) {
        o = make_char4(quant_floor(v.x, scale, w.x),
                       quant_floor(v.y, scale, w.y),
                       quant_floor(v.z, scale, w.z),
                       quant_floor(v.w, scale, w.w));
      } else {
        o = make_char4(quant_rint(v.x, scale), quant_rint(v.y, scale),
                       quant_rint(v.z, scale), quant_rint(v.w, scale));
      }
      reinterpret_cast<char4*>(q)[g] = o;
    } else {
      const unsigned ws[4] = {w.x, w.y, w.z, w.w};
      for (int j = 0; j < 4 && i0 + j < n; ++j)
        q[i0 + j] = stochastic ? quant_floor(x[i0 + j], scale, ws[j])
                               : quant_rint(x[i0 + j], scale);
    }
  }
}

int blocks_for(long long items, int n_sm) {
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(n_sm) * kBlocksPerSm;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

// Quantizes x[0..n) into q and *scale_out on `stream`; amax_scratch is one
// unsigned of device memory. Returns the first CUDA error code (0 on
// success).
extern "C" int quant_int8_launch(int device, void* stream, const float* x,
                                 long long n, int stochastic, unsigned seed,
                                 unsigned* amax_scratch, int8_t* q,
                                 float* scale_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 4 == 0);
  err = cudaMemsetAsync(amax_scratch, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  absmax_kernel<<<blocks_for(vec ? n / 4 + n % 4 : n, n_sm), kThreads, 0, s>>>(
      x, n, vec, amax_scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_kernel<<<blocks_for((n + 3) / 4, n_sm), kThreads, 0, s>>>(
      x, n, vec, amax_scratch, stochastic, seed, q, scale_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quant_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
