// k smallest entries per row of a square squared-distance matrix, under one
// column cap or under every cap of an ascending list in one column stream.
//
// Replaces two Pallas TPU kernels of repro/kernels/topk.py:
//   - _kernel (wrapper topk_select): k passes of (min, first argmin, retire)
//     per row block, self and columns past a dynamic max_idx masked;
//   - _sizes_kernel with _merge_kbest (wrapper topk_select_sizes): one
//     column-tiled pass that snapshots the running k-best at every cap of
//     a CCM convergence sweep.
// Both emit Euclidean distances (sqrt of the squared value, after the
// selection) and int32 column indices, ascending in (value, index) order,
// the tie order of lax.top_k in the reference.
//
// Design. One warp owns one row and walks its columns 32 at a time (one per
// lane), offering each lane's value to the row's k-best list in shared
// memory (kbest::warp_offer); the list is kept in (value, index) order, so
// the result does not depend on the order in which columns arrive.
//   - topk_select: every column enters; self and columns > mx enter as +inf
//     with their real index, which reproduces lax.top_k's fill on rows with
//     fewer than k valid candidates.
//   - topk_select_sizes: columns 0..last (last = min(Lp-1, caps[S-1])) enter
//     in ascending order; self never enters and no column past `last` is
//     read. After column caps[s] the warp writes level s from the running
//     list: a finite slot as (sqrt(d), idx), any other as (inf, -1). A
//     32-column batch that straddles a cap is split there: the lanes up to
//     the cap are offered, the level is written, then the rest of the batch
//     is offered. The TPU kernel's sequential column grid becomes the warp's
//     own loop; the running list stays in shared memory between caps.
//
// What bounds it on the H100: reading D, 4·Lp² bytes (10.2 MB at
// Lp = 1598, ≈3 µs at 3.35 TB/s); the tables are Lp·k·8 bytes per level.
// Each column costs one comparison with the row's k-th best, and each
// insertion a few warp-wide steps.
#include "kbest.cuh"

namespace {

__device__ __forceinline__ float root(float v) {
  return __fsqrt_rn(fmaxf(v, 0.f));
}

// This warp's row list: k distances then k indices per warp, W warps.
struct Lists {
  float* d;
  int* ix;
};

__device__ __forceinline__ Lists warp_lists(int k) {
  extern __shared__ unsigned char smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  float* base = reinterpret_cast<float*>(smem);
  return {base + warp * k, reinterpret_cast<int*>(base + W * k) + warp * k};
}

__global__ void topk_select_kernel(const float* __restrict__ D, int Lp, int k,
                                   int mx, int exclude_self,
                                   float* __restrict__ out_d,
                                   int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (i >= Lp) return;  // whole warp: no block-wide barrier below
  const Lists l = warp_lists(k);
  const float* row = D + (size_t)i * Lp;
  kbest::warp_init(l.d, l.ix, k);
  for (int jb = 0; jb < Lp; jb += 32) {
    const int j = jb + lane;
    const bool live = j < Lp;
    const float v = live ? __ldg(row + j) : INFINITY;
    const bool masked = j > mx || (exclude_self && j == i);
    kbest::warp_offer(l.d, l.ix, k, live, masked ? INFINITY : v, j);
  }
  const size_t base = (size_t)i * k;
  for (int q = lane; q < k; q += 32) {
    out_d[base + q] = root(l.d[q]);
    out_i[base + q] = l.ix[q];
  }
}

// Level s of row i from the running list: finite slots rooted, others
// (inf, -1).
__device__ __forceinline__ void snapshot(const Lists& l, int k, int Lp, int i,
                                         int s, float* out_d, int* out_i) {
  const size_t base = ((size_t)s * Lp + i) * k;
  for (int q = threadIdx.x & 31; q < k; q += 32) {
    const float v = l.d[q];
    const bool ok = isfinite(v);
    out_d[base + q] = ok ? root(v) : INFINITY;
    out_i[base + q] = ok ? l.ix[q] : -1;
  }
  __syncwarp();
}

__global__ void topk_sizes_kernel(const float* __restrict__ D, int Lp, int k,
                                  const int* __restrict__ caps, int S,
                                  int last, int exclude_self,
                                  float* __restrict__ out_d,
                                  int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (i >= Lp) return;
  const Lists l = warp_lists(k);
  const float* row = D + (size_t)i * Lp;
  kbest::warp_init(l.d, l.ix, k);
  int s = 0;
  for (int jb = 0; jb <= last; jb += 32) {
    const int j = jb + lane;
    const bool enters = j <= last && !(exclude_self && j == i);
    const float v = j <= last ? __ldg(row + j) : INFINITY;
    int lo = jb;  // lanes below lo were offered already
    for (; s < S; ++s) {
      const int c = __ldg(caps + s);  // the same for every lane
      if (c >= jb + 32) break;
      kbest::warp_offer(l.d, l.ix, k, enters && j >= lo && j <= c, v, j);
      snapshot(l, k, Lp, i, s, out_d, out_i);
      lo = max(lo, c + 1);
    }
    kbest::warp_offer(l.d, l.ix, k, enters && j >= lo, v, j);
  }
  for (; s < S; ++s) snapshot(l, k, Lp, i, s, out_d, out_i);
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// D: (Lp, Lp) float32 row-major. out_d, out_i: (Lp, k). mx: inclusive column
// cap. One warp per row, warps_per_block rows per block.
// Returns the launch's cudaGetLastError().
extern "C" int topk_select_launch(const float* D, int Lp, int k, int mx,
                                  int exclude_self, int warps_per_block,
                                  float* out_d, int* out_i, void* stream) {
  const size_t smem = (size_t)k * warps_per_block * 8;
  cudaError_t err = set_smem((const void*)topk_select_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Lp + warps_per_block - 1) / warps_per_block;
  topk_select_kernel<<<blocks, warps_per_block * 32, smem,
                       (cudaStream_t)stream>>>(D, Lp, k, mx, exclude_self,
                                               out_d, out_i);
  return (int)cudaGetLastError();
}

// D: (Lp, Lp) float32 row-major. caps: S ascending inclusive caps on the
// device; last = min(Lp - 1, caps[S-1]). out_d, out_i: (S, Lp, k).
// Returns the launch's cudaGetLastError().
extern "C" int topk_sizes_launch(const float* D, int Lp, int k,
                                 const int* caps, int S, int last,
                                 int exclude_self, int warps_per_block,
                                 float* out_d, int* out_i, void* stream) {
  const size_t smem = (size_t)k * warps_per_block * 8;
  cudaError_t err = set_smem((const void*)topk_sizes_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Lp + warps_per_block - 1) / warps_per_block;
  topk_sizes_kernel<<<blocks, warps_per_block * 32, smem,
                      (cudaStream_t)stream>>>(D, Lp, k, caps, S, last,
                                              exclude_self, out_d, out_i);
  return (int)cudaGetLastError();
}
