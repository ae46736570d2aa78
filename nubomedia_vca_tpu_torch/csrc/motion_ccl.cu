// Motion segmentation's connected components, for NVIDIA Hopper (sm_90a):
// the labels of one frame's motion-history image (MHI) in three launches,
// block-based union-find (Playne & Hawick 2018; Allegretti et al. 2019,
// BUF).
//
// Replaces no TPU kernel: the JAX package labels the components with a
// lax.while_loop of min-label propagation and pointer jumping
// (nubomedia_vca_tpu/models/tracker.py). The port ran the same loop, about
// 46 iterations of 14 kernels over [H, W] int64 maps a 720p frame, with a
// host read of a "changed" flag every few iterations (models/tracker.py
// _propagate, which stays as the plain version and the CPU route).
//
// What it computes, bit for bit the plain version's: two 4-neighbours are
// linked when both MHI values are > 0 and |a - b| <= thr, the difference
// and the comparison in float32 (__fsub_rn; the library is built with
// -fmad=false; thr is the float32 of seg_thresh); nothing links across the
// frame's edges. Each pixel's label is the raster index of the first pixel
// of its component; a zero-MHI pixel is its own component.
//
// Union-find with the larger root always linked under the smaller, by
// atomicMin, retried until the root it linked was still a root: a parent
// is never larger than its pixel, so the root of a tree is its smallest
// index, whatever order the unions run in.
//
// 1. ccl_tile_kernel: a block per 32x32 tile, a thread a pixel. The tile's
//    MHI goes to shared memory, each thread evaluates its right and down
//    links and unions them in shared memory; then each pixel's parent in
//    device memory is the global index of its tile-local root (int32).
// 2. ccl_border_kernel: a thread per pixel pair across a tile border (the
//    last row of a tile against the next tile's first, the last column
//    against the next's first): the same union on the global parents.
// 3. ccl_flatten_kernel: a thread a pixel writes its root as int64, the
//    index type that the tracker's scatter reductions read.
//
// Why 32x32: a warp takes one tile row, 128 B of MHI, one cache line; a
// square tile has the shortest border for its area (64 border pixels in
// 1,024), so pass 2 takes about 6% of the pixels; 1,024 threads, a pixel
// each, and 8 KB of shared memory a block.
//
// What bounds it: bytes. The MHI read once (4 B a pixel) and the int64
// labels written once (8 B a pixel) are the least; passes 1 and 3 also
// write and read the int32 parents (8 B a pixel), and pass 3 walks each
// pixel's root chain (its tile's root, then the roots that pass 2 linked),
// reads that stay in L2. No host read between the launches.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;      // tile side, in pixels; a thread a pixel
constexpr int kThreads = 256;  // threads a block of passes 2 and 3

__device__ __forceinline__ bool linked(float a, float b, float thr) {
  return a > 0.0f && b > 0.0f && fabsf(__fsub_rn(a, b)) <= thr;
}

// The root of i in the tile's shared parents (volatile: other threads
// move them while this one walks).
__device__ __forceinline__ int find_shared(volatile int* p, int i) {
  int q = p[i];
  while (q != i) {
    i = q;
    q = p[i];
  }
  return i;
}

// The root of i in the global parents, read from L2 (another block's
// atomicMin may have moved them).
__device__ __forceinline__ int find_global(const int* p, int i) {
  int q = __ldcg(p + i);
  while (q != i) {
    i = q;
    q = __ldcg(p + i);
  }
  return i;
}

// Joins the trees of a and b: the larger root goes under the smaller.
// When the atomicMin finds its root already moved (old != root), the tree
// it had joined is joined again from `old`.
template <bool kShared>
__device__ void unite(int* p, int a, int b) {
  bool done = false;
  while (!done) {
    if constexpr (kShared) {
      a = find_shared(p, a);
      b = find_shared(p, b);
    } else {
      a = find_global(p, a);
      b = find_global(p, b);
    }
    if (a < b) {
      const int old = atomicMin(p + b, a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(p + a, b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  }
}

__global__ void __launch_bounds__(kTile * kTile)
ccl_tile_kernel(const float* __restrict__ mhi, int h, int w, float thr,
                int* __restrict__ parent) {
  __shared__ float s_mhi[kTile][kTile];
  __shared__ int s_parent[kTile * kTile];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * kTile + tx, y = blockIdx.y * kTile + ty;
  const bool inside = x < w && y < h;
  const int li = ty * kTile + tx;
  // a pixel past the frame's edge reads 0, so nothing links to it
  const float a = inside ? mhi[y * w + x] : 0.0f;
  s_mhi[ty][tx] = a;
  s_parent[li] = li;
  __syncthreads();
  if (tx + 1 < kTile && linked(a, s_mhi[ty][tx + 1], thr))
    unite<true>(s_parent, li, li + 1);
  if (ty + 1 < kTile && linked(a, s_mhi[ty + 1][tx], thr))
    unite<true>(s_parent, li, li + kTile);
  __syncthreads();
  if (inside) {
    // local raster order is global raster order inside a tile, so the
    // tile-local root is the piece's first pixel in the frame too
    const int r = find_shared(s_parent, li);
    parent[y * w + x] = (blockIdx.y * kTile + r / kTile) * w +
                        blockIdx.x * kTile + r % kTile;
  }
}

// Pairs across the horizontal borders first (a border row's pixels on
// consecutive threads), then across the vertical borders.
__global__ void __launch_bounds__(kThreads)
ccl_border_kernel(const float* __restrict__ mhi, int h, int w, float thr,
                  int* parent, int n_hpairs, int n_vpairs, int v_borders) {
  int t = blockIdx.x * kThreads + threadIdx.x;
  int p, q;
  if (t < n_hpairs) {
    p = ((t / w + 1) * kTile - 1) * w + t % w;
    q = p + w;
  } else {
    t -= n_hpairs;
    if (t >= n_vpairs) return;
    p = (t / v_borders) * w + (t % v_borders + 1) * kTile - 1;
    q = p + 1;
  }
  if (linked(__ldg(mhi + p), __ldg(mhi + q), thr)) unite<false>(parent, p, q);
}

__global__ void __launch_bounds__(kThreads)
ccl_flatten_kernel(const int* __restrict__ parent, int n,
                   int64_t* __restrict__ labels) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int r = i, q = __ldg(parent + i);
  while (q != r) {
    r = q;
    q = __ldg(parent + r);
  }
  labels[i] = r;
}

}  // namespace

// The labels of the [h, w] float32 MHI at `mhi` into `labels` ([h*w]
// int64), with `parent` ([h*w] int32) as scratch, on `stream`: three
// launches, no synchronisation. h*w must be below 2^31. Returns the CUDA
// error code of the first launch that failed (0 on success).
extern "C" int motion_ccl_launch(int device, void* stream, const float* mhi,
                                 int h, int w, float thr, int* parent,
                                 int64_t* labels) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (w + kTile - 1) / kTile;
  const int tiles_y = (h + kTile - 1) / kTile;
  ccl_tile_kernel<<<dim3(tiles_x, tiles_y), dim3(kTile, kTile), 0, s>>>(
      mhi, h, w, thr, parent);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_hpairs = (tiles_y - 1) * w;
  const int n_vpairs = (tiles_x - 1) * h;
  // at least one block, so that a frame of one tile launches it too
  const int pair_blocks = (n_hpairs + n_vpairs + kThreads - 1) / kThreads;
  ccl_border_kernel<<<pair_blocks > 0 ? pair_blocks : 1, kThreads, 0, s>>>(
      mhi, h, w, thr, parent, n_hpairs, n_vpairs, tiles_x - 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = h * w;
  ccl_flatten_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      parent, n, labels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* motion_ccl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
