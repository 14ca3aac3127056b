// Library-batched all-kNN at one embedding dimension E, one launch for B
// series.
//
// Replaces the Pallas TPU kernel repro/kernels/knn_batch.py::_kernel
// (wrapper all_knn_batch). For series b and embedded row i < Lp it emits
// the k nearest columns j < Lp of D[i, j] = Σ_lag (x[i+lag·τ] - x[j+lag·τ])^2
// in (value, index) order as (B, Lp, k) tables; columns past the cap mx,
// and self, are offered as +inf with their real index (the reference's
// positional fill). Each series is computed by its own blocks with the same
// arithmetic at any B, so the tables are bit-invariant in B.
//
// What bounds it on the H100: float32 ALU work, 3 operations per lag term
// for B·E·Lp² terms (≈0.05 ms at 67 TFLOP/s for 154 × 3 × 1598²); the
// tables (B·Lp·k·8 B) are small. Each column also costs a comparison with
// the row's k-th best.
//
// Two designs, picked by the wrapper by shape; both give the same bits.
//  knn_batch_thread_kernel (k ≤ 32, E ≤ 32): a thread owns one row and
//  half of the columns, a block 64 rows of one series (two threads a row,
//  so that the direct xmap's batches of a few dozen series still fill the
//  card; the halves' lists are merged at the end). The row's E lag values
//  sit in registers and its list of K ∈ {4, 8, 16, 32} slots (k ≤ K: the
//  K first keys hold the k first) in registers too, the levels and slots
//  unrolled by a template. The block stages the series in shared memory,
//  in chunks of columns for long series, and every thread walks its
//  columns in ascending order, reading each column's lag values as
//  broadcasts: four columns' strict chains side by side, one comparison of
//  their minimum with the K-th slot, and an insertion (compare-and-shift
//  down the unrolled slots) only for the few that beat it. Ascending
//  columns make the (value, index) order a strict < on the value against
//  every real slot, so no lane ever waits on a warp-wide vote or a
//  shared-memory list, which is what held the first design back.
//  knn_batch_kernel (any k a block's shared memory holds): one warp owns
//  one row and walks every column, 32 at a time, offering each lane's
//  candidate to the row's k-best list in shared memory (kbest::warp_offer).
#include "kbest.cuh"

namespace {

__global__ void knn_batch_kernel(const float* __restrict__ X, int L, int Lp,
                                 int E, int tau, int k, int mx,
                                 int exclude_self, int row_blocks,
                                 float* __restrict__ out_d,
                                 int* __restrict__ out_i) {
  extern __shared__ unsigned char smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / row_blocks;
  const int i = (blockIdx.x % row_blocks) * W + warp;  // this warp's row
  if (i >= Lp) return;  // whole warp: no block-wide barrier below
  const float* x = X + (size_t)b * L;
  float* sd = reinterpret_cast<float*>(smem) + warp * k;
  int* si = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + W * k) +
            warp * k;

  kbest::warp_init(sd, si, k);
  for (int jb = 0; jb < Lp; jb += 32) {
    const int j = jb + lane;
    const bool live = j < Lp;
    const int jr = live ? j : 0;  // in-range read for idle lanes
    float acc = 0.f;
    for (int e = 0; e < E; ++e)
      acc = kbest::add_sq(acc, __ldg(x + i + e * tau),
                          __ldg(x + jr + e * tau));
    const bool masked = j > mx || (exclude_self && j == i);
    kbest::warp_offer(sd, si, k, live, masked ? INFINITY : acc, j);
  }
  const size_t base = ((size_t)b * Lp + i) * k;
  for (int q = lane; q < k; q += 32) {
    out_d[base + q] = __fsqrt_rn(sd[q]);
    out_i[base + q] = si[q];
  }
}

constexpr int kThreads = 128;   // threads per block of the first design
constexpr int kThreadRows = 64;  // rows per block: two threads a row
constexpr int kChunk = 4096;     // columns staged per pass

// Insert (v, j) into the sorted slots d/ix, dropping the last; the caller
// has checked that it beats the last. Slot q takes its predecessor when the
// candidate precedes that, else the candidate when it precedes slot q.
template <int K>
__device__ __forceinline__ void insert_sorted(float (&d)[K], int (&ix)[K],
                                              float v, int j) {
#pragma unroll
  for (int q = K - 1; q > 0; --q) {
    if (kbest::before(v, j, d[q - 1], ix[q - 1])) {
      d[q] = d[q - 1];
      ix[q] = ix[q - 1];
    } else if (kbest::before(v, j, d[q], ix[q])) {
      d[q] = v;
      ix[q] = j;
    }
  }
  if (kbest::before(v, j, d[0], ix[0])) {
    d[0] = v;
    ix[0] = j;
  }
}

// The same for a finite v < d[K-1] from a column past every listed one:
// the order is then the value's alone.
template <int K>
__device__ __forceinline__ void insert_value(float (&d)[K], int (&ix)[K],
                                             float v, int j) {
#pragma unroll
  for (int q = K - 1; q > 0; --q) {
    const bool up = v < d[q - 1];
    const bool here = !up && v < d[q];
    d[q] = up ? d[q - 1] : here ? v : d[q];
    ix[q] = up ? ix[q - 1] : here ? j : ix[q];
  }
  if (v < d[0]) {
    d[0] = v;
    ix[0] = j;
  }
}

// Offer column j's value v, masked (past mx, or self) as +inf.
template <int K>
__device__ __forceinline__ void offer(float (&d)[K], int (&ix)[K], float v,
                                      int j, int ir, int mx,
                                      int exclude_self) {
  if (j > mx || (exclude_self && j == ir)) v = INFINITY;
  if (kbest::before(v, j, d[K - 1], ix[K - 1])) insert_sorted<K>(d, ix, v, j);
}

// grid B · ⌈Lp / kThreadRows⌉ blocks of kThreads threads: the first half
// of the threads takes the first half of each chunk's columns for rows
// i0.., the second half the rest for the same rows, and the two lists are
// merged at the end. Shared memory: max(min(Lp, kChunk) + (E-1)·τ,
// 2·K·kThreadRows) floats. Columns go four at a time: four independent
// chains, then one comparison of each with the K-th slot, and the cheap
// value-only insertion for the few that pass, one per pass of a loop that
// each lane leaves when its own are in (a warp pays for its lanes' largest
// count, not for every lane's). Ascending columns make that exact: a
// column's index exceeds every listed one, so it precedes the K-th slot of
// a full list only by a smaller value. A group that holds a masked column
// (self, or past mx), a list with empty slots, and the tail of a half take
// the full (value, index) path.
template <int K, int kE>
__global__ void __launch_bounds__(kThreads)
knn_batch_thread_kernel(const float* __restrict__ X, int L, int Lp, int E,
                        int tau, int k, int mx, int exclude_self,
                        int row_blocks, float* __restrict__ out_d,
                        int* __restrict__ out_i) {
  extern __shared__ float xs[];
  const int b = blockIdx.x / row_blocks;
  const int i0 = (blockIdx.x - b * row_blocks) * kThreadRows;
  const int half = threadIdx.x / kThreadRows;  // warp-uniform
  const int i = i0 + threadIdx.x % kThreadRows;
  const int ir = min(i, Lp - 1);  // a thread past Lp computes, never writes
  const float* x = X + (size_t)b * L;
  float xi[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) xi[e] = e < E ? __ldg(x + ir + e * tau) : 0.f;
  float d[K];
  int ix[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    d[q] = INFINITY;
    ix[q] = kbest::kEmpty;
  }
  const int span = (E - 1) * tau;
  // Groups outside [self_lo, self_hi) hold no row of this block.
  const int self_lo = exclude_self ? i0 : Lp, self_hi = i0 + kThreadRows;
  for (int j0 = 0; j0 < Lp; j0 += kChunk) {
    const int n = min(kChunk, Lp - j0);
    __syncthreads();  // the previous chunk is read
    for (int q = threadIdx.x; q < n + span; q += kThreads)
      xs[q] = __ldg(x + j0 + q);
    __syncthreads();
    const int mid = (n >> 1) & ~3;
    int jj = half ? mid : 0;
    const int jend = half ? n : mid;
    for (; jj + 4 <= jend; jj += 4) {
      const int j = j0 + jj;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        if (e >= E) break;
        const float* c = xs + jj + e * tau;
        a0 = kbest::add_sq(a0, xi[e], c[0]);
        a1 = kbest::add_sq(a1, xi[e], c[1]);
        a2 = kbest::add_sq(a2, xi[e], c[2]);
        a3 = kbest::add_sq(a3, xi[e], c[3]);
      }
      if (j + 3 <= mx && (j + 3 < self_lo || j >= self_hi) &&
          ix[K - 1] != kbest::kEmpty) {
        // A full list: a column precedes the K-th slot iff its value is
        // smaller. Each lane inserts only its own few, one per pass.
        const float t = d[K - 1];
        unsigned pend = (a0 < t ? 1u : 0u) | (a1 < t ? 2u : 0u) |
                        (a2 < t ? 4u : 0u) | (a3 < t ? 8u : 0u);
        while (pend) {
          const int q = __ffs(pend) - 1;
          pend &= pend - 1;
          const float v = q == 0 ? a0 : q == 1 ? a1 : q == 2 ? a2 : a3;
          if (v < d[K - 1]) insert_value<K>(d, ix, v, j + q);
        }
      } else {
        offer<K>(d, ix, a0, j, ir, mx, exclude_self);
        offer<K>(d, ix, a1, j + 1, ir, mx, exclude_self);
        offer<K>(d, ix, a2, j + 2, ir, mx, exclude_self);
        offer<K>(d, ix, a3, j + 3, ir, mx, exclude_self);
      }
    }
    for (; jj < jend; ++jj) {
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        if (e >= E) break;
        acc = kbest::add_sq(acc, xi[e], xs[jj + e * tau]);
      }
      offer<K>(d, ix, acc, j0 + jj, ir, mx, exclude_self);
    }
  }
  // The second half's lists into the first's, by the (value, index) key.
  __syncthreads();  // the last chunk is read
  float* md = xs + (threadIdx.x % kThreadRows) * K;
  int* mi = reinterpret_cast<int*>(xs + kThreadRows * K) +
            (threadIdx.x % kThreadRows) * K;
  if (half) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      md[q] = d[q];
      mi[q] = ix[q];
    }
  }
  __syncthreads();
  if (half || i >= Lp) return;
  for (int q = 0; q < K; ++q) {  // sorted: the first that fails ends it
    const float v = md[q];
    const int j = mi[q];
    if (!kbest::before(v, j, d[K - 1], ix[K - 1])) break;
    insert_sorted<K>(d, ix, v, j);
  }
  const size_t base = ((size_t)b * Lp + i) * k;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (q < k) {
      out_d[base + q] = __fsqrt_rn(d[q]);
      out_i[base + q] = ix[q];
    }
  }
}

template <int K, int kE>
cudaError_t launch_thread(const float* X, int B, int L, int Lp, int E,
                          int tau, int k, int mx, int exclude_self,
                          float* out_d, int* out_i, cudaStream_t stream) {
  const int cols = (Lp < kChunk ? Lp : kChunk) + (E - 1) * tau;
  const int lists = 2 * K * kThreadRows;
  const size_t smem = (size_t)(cols > lists ? cols : lists) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      knn_batch_thread_kernel<K, kE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int row_blocks = (Lp + kThreadRows - 1) / kThreadRows;
  knn_batch_thread_kernel<K, kE>
      <<<(unsigned)B * row_blocks, kThreads, smem, stream>>>(
          X, L, Lp, E, tau, k, mx, exclude_self, row_blocks, out_d, out_i);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_thread_e(const float* X, int B, int L, int Lp, int E,
                            int tau, int k, int mx, int exclude_self,
                            float* out_d, int* out_i, cudaStream_t s) {
  return E <= 4 ? launch_thread<K, 4>(X, B, L, Lp, E, tau, k, mx,
                                      exclude_self, out_d, out_i, s)
       : E <= 8 ? launch_thread<K, 8>(X, B, L, Lp, E, tau, k, mx,
                                      exclude_self, out_d, out_i, s)
       : E <= 16 ? launch_thread<K, 16>(X, B, L, Lp, E, tau, k, mx,
                                        exclude_self, out_d, out_i, s)
                 : launch_thread<K, 32>(X, B, L, Lp, E, tau, k, mx,
                                        exclude_self, out_d, out_i, s);
}

}  // namespace

// X: (B, L) float32. out_d, out_i: (B, Lp, k), Lp = L - (E-1)·tau.
// One warp per row, warps_per_block rows per block.
// Returns the launch's cudaGetLastError().
extern "C" int knn_batch_launch(const float* X, int B, int L, int E, int tau,
                                int k, int mx, int exclude_self,
                                int warps_per_block, float* out_d, int* out_i,
                                void* stream) {
  const int Lp = L - (E - 1) * tau;
  const size_t smem = (size_t)k * warps_per_block * 8;
  cudaError_t err = cudaFuncSetAttribute(
      knn_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (Lp + warps_per_block - 1) / warps_per_block;
  knn_batch_kernel<<<(unsigned)B * row_blocks, warps_per_block * 32, smem,
                     (cudaStream_t)stream>>>(X, L, Lp, E, tau, k, mx,
                                             exclude_self, row_blocks, out_d,
                                             out_i);
  return (int)cudaGetLastError();
}

// The thread-per-row kernel: the same arguments as knn_batch_launch but no
// block shape (kThreadRows rows per block, two threads a row); k ≤ 32,
// E ≤ 32, and max(min(Lp, kChunk) + (E-1)·τ, 2·K·kThreadRows)·4 bytes of
// shared memory per block (K the list size k rounds up to).
extern "C" int knn_batch_thread_launch(const float* X, int B, int L, int E,
                                       int tau, int k, int mx,
                                       int exclude_self, float* out_d,
                                       int* out_i, void* stream) {
  const int Lp = L - (E - 1) * tau;
  if (B < 1 || E < 1 || E > 32 || k < 1 || k > 32 || Lp < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      k <= 4 ? launch_thread_e<4>(X, B, L, Lp, E, tau, k, mx, exclude_self,
                                  out_d, out_i, s)
    : k <= 8 ? launch_thread_e<8>(X, B, L, Lp, E, tau, k, mx, exclude_self,
                                  out_d, out_i, s)
    : k <= 16 ? launch_thread_e<16>(X, B, L, Lp, E, tau, k, mx, exclude_self,
                                    out_d, out_i, s)
              : launch_thread_e<32>(X, B, L, Lp, E, tau, k, mx, exclude_self,
                                    out_d, out_i, s);
  return (int)err;
}
