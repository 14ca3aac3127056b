// Grow a panel's multi-E kNN master tables by dt appended points, one
// launch for every series and level.
//
// Replaces the Pallas TPU kernel repro/kernels/knn_append.py::_select_kernel
// (driven by _master_append, wrapper master_append). The TPU kernel only
// selects: XLA forms the candidate values beforehand, one series per call.
// Here one kernel forms the candidates and selects, for an (N, L_new) panel
// and every level e (E = e + 1) of its (N, E_max, L_old, k) master, and
// writes the (N, E_max, L_new, k) tables that a cold all_knn_multi_e build
// of the grown panel would write, bit for bit:
//   - an old row i < Lp_old = L_old - e·τ merges its k stored candidates
//     with the dt new columns [Lp_old, Lp_new). The stored candidates'
//     squared distances are recomputed from the series (the list keeps
//     only their roots), by the strict chain of kbest.cuh, so they are the
//     bits the cold build compared. A stored slot holding inf (a level with
//     fewer candidates than k) enters as +inf with the distinct index
//     kSentinel + slot: its old index may name a column that is valid now.
//     When inf slots survive the merge they are rewritten to the cold
//     build's pattern (self at the first, then the slot number), as
//     ref.normalize_garbage does.
//   - a new row Lp_old <= i < Lp_new scans every column as the cold build
//     does (columns past Lp_new - 1, and self, as +inf with their index).
//   - a row i >= Lp_new is padding: inf / -1.
//
// Design. One warp owns one (series, level, row) and a k-slot list in
// shared memory kept in (value, index) order (kbest::warp_offer). A stored
// list is already in that order, so it is loaded as it is, and only the dt
// new columns are offered; a list that is not in order (no master built by
// all_knn_multi_e or by this kernel) is offered slot by slot instead, so
// the result is the same selection either way.
//
// What bounds it on the H100: moving the tables, (N·E_max·k·8 B) read at
// L_old and written at L_new (≈1.7 GB at 154 × 20 × 1600 × 22, ≈0.5 ms at
// 3.35 TB/s); the chains, 3 operations per lag term for
// N·Σ_e (e+1)·(Lp_old_e·k + dt·L_new) terms (3.4 GFLOP at dt = 1 and
// 13 GFLOP at dt = 64 there, 0.05–0.2 ms at 67 TFLOP/s). The new rows each
// scan L_new columns, and each stored candidate is a gather of e + 1 series
// values.
#include "kbest.cuh"

namespace {

constexpr int kSentinel = 1 << 30;

// Squared distance of rows i and j at level e: the strict chain over lags.
__device__ __forceinline__ float chain(const float* __restrict__ x, int i,
                                       int j, int e, int tau) {
  float acc = 0.f;
  for (int l = 0; l <= e; ++l)
    acc = kbest::add_sq(acc, __ldg(x + i + l * tau), __ldg(x + j + l * tau));
  return acc;
}

__global__ void knn_append_kernel(const float* __restrict__ xpad, int Lx,
                                  int L_old, int L_new, int E_max, int tau,
                                  int k, const float* __restrict__ dM,
                                  const int* __restrict__ iM, int row_blocks,
                                  float* __restrict__ out_d,
                                  int* __restrict__ out_i) {
  extern __shared__ unsigned char smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int se = blockIdx.x / row_blocks;  // series · E_max + level
  const int s = se / E_max;
  const int e = se % E_max;
  const int i = (blockIdx.x % row_blocks) * W + warp;  // this warp's row
  if (i >= L_new) return;  // whole warp: no block-wide barrier below
  const float* x = xpad + (size_t)s * Lx;
  const int Lp_old = L_old - e * tau;
  const int Lp_new = L_new - e * tau;
  const size_t obase = ((size_t)se * L_new + i) * k;
  if (i >= Lp_new) {
    for (int q = lane; q < k; q += 32) {
      out_d[obase + q] = INFINITY;
      out_i[obase + q] = -1;
    }
    return;
  }
  float* sd = reinterpret_cast<float*>(smem) + warp * k;
  int* si = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + W * k) +
            warp * k;

  if (i < Lp_old) {
    const size_t ibase = ((size_t)se * L_old + i) * k;
    // Stored slot q as a candidate: (recomputed value, index), or +inf
    // with a sentinel index where the slot held no neighbour.
    auto stored = [&](int q, float& v, int& j) {
      const int jq = __ldg(iM + ibase + q);
      if (isfinite(__ldg(dM + ibase + q))) {
        v = chain(x, i, jq, e, tau);
        j = jq;
      } else {
        v = INFINITY;
        j = kSentinel + q;
      }
    };
    for (int q = lane; q < k; q += 32) stored(q, sd[q], si[q]);
    __syncwarp();
    bool unordered = false;
    for (int q = lane; q + 1 < k; q += 32)
      unordered |= kbest::before(sd[q + 1], si[q + 1], sd[q], si[q]);
    if (__any_sync(kbest::kFull, unordered)) {
      kbest::warp_init(sd, si, k);
      for (int q0 = 0; q0 < k; q0 += 32) {
        const int q = q0 + lane;
        float v = INFINITY;
        int j = kbest::kEmpty;
        if (q < k) stored(q, v, j);
        kbest::warp_offer(sd, si, k, q < k, v, j);
      }
    }
    for (int c0 = Lp_old; c0 < Lp_new; c0 += 32) {
      const int c = c0 + lane;
      const bool live = c < Lp_new;
      kbest::warp_offer(sd, si, k, live,
                        live ? chain(x, i, c, e, tau) : INFINITY, c);
    }
    // The finite slots are a prefix of the list; the rest is garbage.
    int nfin = 0;
    for (int q0 = 0; q0 < k; q0 += 32) {
      const int q = q0 + lane;
      nfin += __popc(__ballot_sync(kbest::kFull, q < k && isfinite(sd[q])));
    }
    for (int q = lane; q < k; q += 32) {
      const bool fin = isfinite(sd[q]);
      out_d[obase + q] = fin ? __fsqrt_rn(sd[q]) : INFINITY;
      out_i[obase + q] = fin ? si[q] : (q == nfin ? i : q);
    }
    return;
  }

  // A new row: every column, masked as the cold build masks it.
  kbest::warp_init(sd, si, k);
  for (int jb = 0; jb < L_new; jb += 32) {
    const int j = jb + lane;
    const bool live = j < L_new;
    const bool masked = j > Lp_new - 1 || j == i;
    kbest::warp_offer(sd, si, k, live,
                      (masked || !live) ? INFINITY : chain(x, i, j, e, tau),
                      j);
  }
  for (int q = lane; q < k; q += 32) {
    out_d[obase + q] = __fsqrt_rn(sd[q]);
    out_i[obase + q] = si[q];
  }
}

}  // namespace

// xpad: (N, Lx) float32, each series zero-padded to Lx = L_new + (E_max-1)·τ.
// dM, iM: (N, E_max, L_old, k) stored master. out_d, out_i:
// (N, E_max, L_new, k). One warp per row, warps_per_block rows per block.
// Returns the launch's cudaGetLastError().
extern "C" int knn_append_launch(const float* xpad, int N, int Lx, int L_old,
                                 int L_new, int E_max, int tau, int k,
                                 const float* dM, const int* iM,
                                 int warps_per_block, float* out_d,
                                 int* out_i, void* stream) {
  if (N < 1 || E_max < 1 || k < 1 || L_new <= L_old)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)k * warps_per_block * 8;
  cudaError_t err = cudaFuncSetAttribute(
      knn_append_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (L_new + warps_per_block - 1) / warps_per_block;
  knn_append_kernel<<<(unsigned)N * E_max * row_blocks, warps_per_block * 32,
                      smem, (cudaStream_t)stream>>>(
      xpad, Lx, L_old, L_new, E_max, tau, k, dM, iM, row_blocks, out_d,
      out_i);
  return (int)cudaGetLastError();
}
