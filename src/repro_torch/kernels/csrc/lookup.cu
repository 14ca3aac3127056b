// Batched simplex lookup: predictions of N targets from one neighbour table.
//
// Replaces the Pallas TPU kernel repro/kernels/lookup.py::_kernel_lookup
// (wrapper lookup; paper Algorithm 3). For target n and row j < rows it
// writes
//     out[n, j] = Σ_q w[j, q] · Y[n, clamp(idx[j, q] + off, 0, L-1)]
// with the k products rounded on their own and summed left to right from
// the first (__fmul_rn / __fadd_rn), the fixed order of the plain
// version's ref.sum_last, so the bits equal it. Invalid slots carry
// idx = -1 and weight 0; the clamp keeps their read in range.
//
// What bounds it on the H100: at the simplex path's shapes (N = 1, rows
// ≈ 1600, k = E + 1) the launch itself, far above the bytes (the table,
// rows·k·8, Y and out: ≈64 KB, 0.02 µs at 3.35 TB/s) and the 2 operations
// a gathered term. What a design can cut is the chain of dependent memory
// round trips inside the launch, and the memory instructions on it.
//
// Design. The first design gave one thread a row in blocks of 256 (7 blocks
// at rows = 1597) and walked the k slots one at a time, each a dependent
// read of the slot's index and then of Y at it. Here a thread still takes
// one row (the stores of out stay coalesced) in blocks of kRows = 64 (25
// blocks), and takes its slots four at a time: the four indices and the
// four weights in one 16-byte load each where k is a multiple of 4 and
// the table is 16-byte aligned (every row then is), else in four word
// loads issued together; then the four gathers of Y, issued together;
// then the four products summed in order. At k ≤ 4 that is two round
// trips a row, and the kernel is straight-line code: each loop (over
// batches of slots, or over targets) and each early exit measured
// 0.04–0.09 µs on a launch of ≈1.3 µs, so k ≤ 4 (E ≤ 3, the session's
// usual embeddings) takes a kernel without them, larger k the batch loop;
// a thread past the last row reads the last row and stores nothing, and
// target n is grid row n (the launcher splits more than 65,535 targets).
// Staging the block's table rows and the series in shared memory with
// cp.async (one round trip, then shared-memory gathers) was slower at
// every block size tried (32 to 256 rows), with the table staged or read
// in place: every block copying the whole series cost more than the trip
// it saved.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;  // rows (threads) a block
constexpr int kMaxGridY = 65535;

// Slots q0 .. q0 + 3 of a row (m of them in the table) added to acc in
// order: their indices and weights, then their gathers, then the sums.
template <bool kVec>
__device__ __forceinline__ float add_slots(const float* __restrict__ y,
                                           int L, const int* __restrict__ ij,
                                           const float* __restrict__ wj,
                                           int q0, int m, int off,
                                           float acc) {
  int c[4];
  float wq[4];
  if constexpr (kVec) {
    const int4 iv = __ldg(reinterpret_cast<const int4*>(ij + q0));
    const float4 wv = __ldg(reinterpret_cast<const float4*>(wj + q0));
    c[0] = iv.x;
    c[1] = iv.y;
    c[2] = iv.z;
    c[3] = iv.w;
    wq[0] = wv.x;
    wq[1] = wv.y;
    wq[2] = wv.z;
    wq[3] = wv.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c[u] = u < m ? __ldg(ij + q0 + u) : 0;
      wq[u] = u < m ? __ldg(wj + q0 + u) : 0.f;
    }
  }
  float yv[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    yv[u] = u < m ? __ldg(y + min(max(c[u] + off, 0), L - 1)) : 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float t = __fmul_rn(yv[u], wq[u]);
    if (u < m) acc = q0 + u == 0 ? t : __fadd_rn(acc, t);
  }
  return acc;
}

// kLoop: k > 4, slots in batches of four; else k ≤ 4, one batch.
template <bool kVec, bool kLoop>
__global__ void __launch_bounds__(kRows)
lookup_kernel(const float* __restrict__ Y, int L,
              const int* __restrict__ idx, const float* __restrict__ w,
              int rows, int k, int off, float* __restrict__ out) {
  const int j = blockIdx.x * kRows + threadIdx.x;
  const int jr = min(j, rows - 1);
  const int* ij = idx + (size_t)jr * k;
  const float* wj = w + (size_t)jr * k;
  const float* y = Y + (size_t)blockIdx.y * L;
  float acc = 0.f;
  if constexpr (kLoop) {
    for (int q0 = 0; q0 < k; q0 += 4)
      acc = add_slots<kVec>(y, L, ij, wj, q0, k - q0, off, acc);
  } else {
    acc = add_slots<kVec>(y, L, ij, wj, 0, k, off, acc);
  }
  if (j < rows) out[(size_t)blockIdx.y * rows + j] = acc;
}

template <bool kVec, bool kLoop>
cudaError_t launch(const float* Y, int L, int N, const int* idx,
                   const float* w, int rows, int k, int off, float* out,
                   cudaStream_t st) {
  for (int n0 = 0; n0 < N; n0 += kMaxGridY) {
    const dim3 grid((rows + kRows - 1) / kRows,
                    N - n0 < kMaxGridY ? N - n0 : kMaxGridY);
    lookup_kernel<kVec, kLoop><<<grid, kRows, 0, st>>>(
        Y + (size_t)n0 * L, L, idx, w, rows, k, off, out + (size_t)n0 * rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Y: (N, L) float32. idx, w: (rows, k) contiguous, k >= 1. out: (N, rows).
// Returns the launch's cudaGetLastError().
extern "C" int lookup_launch(const float* Y, int L, int N, const int* idx,
                             const float* w, int rows, int k, int off,
                             float* out, void* stream) {
  if (k < 1 || rows < 1 || N < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const bool vec =
      k % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(w)) &
       15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (k <= 4)
    err = vec ? launch<true, false>(Y, L, N, idx, w, rows, k, off, out, st)
              : launch<false, false>(Y, L, N, idx, w, rows, k, off, out, st);
  else
    err = vec ? launch<true, true>(Y, L, N, idx, w, rows, k, off, out, st)
              : launch<false, true>(Y, L, N, idx, w, rows, k, off, out, st);
  return (int)err;
}
