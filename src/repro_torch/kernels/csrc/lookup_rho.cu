// Fused simplex lookup + Pearson ρ for a batch of neighbour tables.
//
// Replaces the Pallas TPU kernel repro/kernels/lookup.py::_kernel_rho (with
// _gather_tile; wrapper lookup_rho). For table b (rows × k indices I and
// weights W) and target n it forms the prediction
//     yhat[j] = Σ_q W[b, j, q] · Y[n, clamp(I[b, j, q] + off, 0, L-1)]
// (the k-sum a left-to-right chain of rounded products and sums, as the
// plain ref.lookup) and returns the Pearson correlation of yhat with the
// aligned truth Y[n, j + off] over j < rows, or 0 where a variance is 0.
// yhat is never stored. Two target modes:
//   - all targets: out (B, Nt), table b against every target of Y;
//   - own target:  out (B,),    table b against series b only (the ρ(E)
//     sweep of the optimal-E search).
// Invalid slots carry I = -1 and W = 0; the clamp keeps their read in range.
//
// The moment order, fixed by rows alone (never by B, Nt or the card), so a
// (b, n) result has the same bits whatever else the launch holds:
//   - a tile is 32 consecutive rows; its rows are summed as four slot
//     partials P_s = Σ_{r<8} v[4r + s] (left to right from 0), then
//     (P_0 + P_1) + (P_2 + P_3), in float32;
//   - a tile's moments are two-pass, as the TPU kernel's tiles: the means
//     S(yhat)/n_t and S(truth)/n_t, then S(da·da), S(db·db), S(da·db) of
//     the centred values (rows past `rows` add 0);
//   - a chunk is 8 tiles (256 rows); its tiles are merged by the
//     Chan/Schubert–Gertz formula in float64 as a tree (tile w with w + 4,
//     then w + 2, then w + 1), with one division a merge (t = n_y / n);
//   - the chunks are merged in chunk order in float64, and ρ is taken in
//     float64 and rounded once.
// Float64 for the merges: in float32 the same order sat as far from the
// plain version as the first design's Welford merges, further than the
// plain version from a float64 Pearson, and the optimal-E argmax rests on
// top-two ρ(E) gaps only a few times that error; with float64 merges the
// tiles' float32 sums are the only rounding left.
//
// Design. The first design gave one block a whole table (B blocks, one for
// B = 1), each thread a Welford update with two divisions a row at the end
// of a dependent gather chain, and read the tables 32 rows apart across a
// warp. Here one block takes one chunk of one table (and 32 targets in the
// all-targets form), so a B = 1 launch of 1600 rows is 7 blocks. The
// chunk's indices and weights are staged once in shared memory with
// cp.async (16-byte copies where the table's rows are contiguous, which
// row-sliced views keep; word copies otherwise; tables with k > 32 are
// read in place). Warp w takes tile w.
//   - All targets: the caller's transposed panel Yt (L, Ntp), Ntp a
//     multiple of 32, zero-padded; lane g + 8s takes targets 4g..4g+3 of
//     the block's 32 (one float4) and rows 4r + s of the tile (r < 8): one
//     index read serves four gathers, the 8 lanes of a row read one
//     128-byte line, the four rows a warp reads at once are consecutive in
//     shared memory, and the 8 rows' k-sums run side by side (8 gathers in
//     flight a lane). The tile's sums are the thread's 8 rows then two
//     butterfly shuffles; the truth is read again for the centred pass
//     rather than held in registers.
//   - Own target (and all targets with Nt = 1, a series stride of 0): lane
//     i takes row i of the tile, the slot partials are shuffles, and the
//     series itself is staged beside the tables (up to 12,288 points):
//     its gathers hit 32 scattered words a warp, which the L1 serves a
//     sector at a time.
//   - Per-(b, n, chunk) float64 moments go to a scratch buffer the wrapper
//     allocates, and a second small kernel merges them in chunk order
//     (a launch of one chunk writes ρ itself).
//
// What bounds it on the H100: in the own-target form the tables' bytes
// (8 bytes a slot, 40.9 MB at E = 20 on a 154 × 1600 panel); in the
// all-targets form the float32 work of the gathers (2 operations a slot
// and target) against tables and targets of a few MB, and in practice
// the gathered float4 reads, B·rows·k·Nt·4 bytes through L1 (606 MB at
// 154 tables × 154 targets, k = 4) with what misses it from L2; the
// blocks of one target tile run together (the tile index is the grid's
// slow axis) so that its slice of Yt stays in L1.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;        // tiles per chunk, one warp each
constexpr int kTileRows = 32;    // rows per tile
constexpr int kChunkRows = kWarps * kTileRows;
constexpr int kGroups = 8;       // float4 target groups a block
constexpr int kTargets = 4 * kGroups;
constexpr int kSlots = 32 / kGroups;  // lanes a tile's rows are dealt to
constexpr int kSlotRows = kTileRows / kSlots;
constexpr int kMoments = 6;

struct M {
  double n, ma, mb, m2a, m2b, c;
};

__device__ __forceinline__ M merge(const M& x, const M& y) {
  if (y.n == 0.0) return x;
  if (x.n == 0.0) return y;
  M r;
  r.n = x.n + y.n;
  const double t = y.n / r.n;  // the merge's one division
  const double da = y.ma - x.ma;
  const double db = y.mb - x.mb;
  const double f = x.n * t;
  r.ma = x.ma + da * t;
  r.mb = x.mb + db * t;
  r.m2a = x.m2a + y.m2a + da * da * f;
  r.m2b = x.m2b + y.m2b + db * db * f;
  r.c = x.c + y.c + da * db * f;
  return r;
}

__device__ __forceinline__ float rho_of(const M& m) {
  const double den = sqrt(m.m2a * m.m2b);
  return den > 0.0 ? (float)(m.c / fmax(den, 1e-30)) : 0.f;
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Copy nr rows of k words (row stride sr) into dst; returns the word
// offset at which row 0 slot 0 lands. Contiguous rows go as one span, in
// 16-byte copies between a head and a tail of word copies (dst is
// 16-byte aligned and the span keeps its source alignment).
template <typename T>
__device__ __forceinline__ int stage(const T* src, long long sr, int k,
                                     int nr, T* dst) {
  const int n = nr * k;
  if (sr == k) {
    const int a = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    const int h = min((4 - a) & 3, n);
    const int nq = (n - h) >> 2;
    for (int u = threadIdx.x; u < h; u += blockDim.x)
      cp4(dst + a + u, src + u);
    for (int v = threadIdx.x; v < nq; v += blockDim.x)
      cp16(dst + a + h + 4 * v, src + h + 4 * v);
    for (int u = h + 4 * nq + threadIdx.x; u < n; u += blockDim.x)
      cp4(dst + a + u, src + u);
    return a;
  }
  for (int u = threadIdx.x; u < n; u += blockDim.x) {
    const int r = u / k;
    cp4(dst + u, src + r * sr + (u - r * k));
  }
  return 0;
}

// The tile sum of one row a lane (own-target lanes: row i = lane): the
// slot partials P_s = Σ_r v[4r + s], then two butterflies.
__device__ __forceinline__ float tile_sum1(float v) {
  const int s = threadIdx.x & (kSlots - 1);
  float p = 0.f;
#pragma unroll
  for (int r = 0; r < kSlotRows; ++r)
    p = __fadd_rn(p, __shfl_sync(kFull, v, s + kSlots * r));
#pragma unroll
  for (int m = 1; m < kSlots; m <<= 1)
    p = __fadd_rn(p, __shfl_xor_sync(kFull, p, m));
  return p;
}

// Two-pass moments of one tile of one row a lane.
__device__ __forceinline__ M tile_moments1(float a, float b, bool ok,
                                           float nt) {
  if (nt == 0.f) return M{0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const float ma = __fdiv_rn(tile_sum1(a), nt);
  const float mb = __fdiv_rn(tile_sum1(b), nt);
  const float da = ok ? __fsub_rn(a, ma) : 0.f;
  const float db = ok ? __fsub_rn(b, mb) : 0.f;
  return M{(double)nt, (double)ma, (double)mb,
           (double)tile_sum1(__fmul_rn(da, da)),
           (double)tile_sum1(__fmul_rn(db, db)),
           (double)tile_sum1(__fmul_rn(da, db))};
}

__device__ __forceinline__ void store(double* p, const M& m,
                                      long long stride = 1) {
  p[0] = m.n;
  p[stride] = m.ma;
  p[2 * stride] = m.mb;
  p[3 * stride] = m.m2a;
  p[4 * stride] = m.m2b;
  p[5 * stride] = m.c;
}

__device__ __forceinline__ M load(const double* p, long long stride) {
  return M{p[0], p[stride], p[2 * stride], p[3 * stride], p[4 * stride],
           p[5 * stride]};
}

// Shared memory: the staged indices, then the weights (each 4 words of
// alignment slack), then the tiles' moments; sizes in words.
__host__ __device__ inline int stage_words(int k) {
  return ((kChunkRows * k + 4) + 3) & ~3;
}

__host__ __device__ inline int series_words(int L) { return (L + 7) & ~3; }

// The chunk's tree of tile moments, mom[w][t][m] for w < kWarps and t <
// nt targets, merged into mom[0][t]; then ρ or the chunk's scratch row.
__device__ __forceinline__ void finish_chunk(double* mom, int nt_blk,
                                             int n0, int nvalid, int nch,
                                             int ch, long long out0,
                                             long long bn_total,
                                             double* __restrict__ part,
                                             float* __restrict__ out) {
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int h = kWarps / 2; h >= 1; h >>= 1) {
    __syncthreads();
    if (warp < h && t < nt_blk) {
      double* x = mom + (warp * nt_blk + t) * kMoments;
      const M r = merge(load(x, 1),
                        load(mom + ((warp + h) * nt_blk + t) * kMoments, 1));
      store(x, r);
    }
  }
  __syncthreads();
  if (warp == 0 && t < nt_blk && n0 + t < nvalid) {
    const M r = load(mom + t * kMoments, 1);
    if (nch == 1) {
      out[out0 + t] = rho_of(r);
    } else {
      store(part + (long long)ch * kMoments * bn_total + out0 + t, r,
            bn_total);
    }
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
}

__device__ __forceinline__ float4 sub4(const float4& a, const float4& b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                     __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
}

__device__ __forceinline__ float4 mul4(const float4& a, const float4& b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                     __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float4 div4(const float4& a, float n) {
  return make_float4(__fdiv_rn(a.x, n), __fdiv_rn(a.y, n), __fdiv_rn(a.z, n),
                     __fdiv_rn(a.w, n));
}

// A thread's slot partials (float4) to the tile sum: two butterflies.
__device__ __forceinline__ float4 tile_sum4(float4 p) {
#pragma unroll
  for (int m = kGroups; m < 32; m <<= 1)
    add4(p, make_float4(__shfl_xor_sync(kFull, p.x, m),
                        __shfl_xor_sync(kFull, p.y, m),
                        __shfl_xor_sync(kFull, p.z, m),
                        __shfl_xor_sync(kFull, p.w, m)));
  return p;
}

// The truth of row r of the thread (zero past `rows`).
__device__ __forceinline__ float4 truth(const float4* __restrict__ Yt4,
                                        unsigned valid, int r, int row,
                                        int Ntp4, int n4) {
  return ((valid >> r) & 1u) ? __ldg(Yt4 + (long long)row * Ntp4 + n4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
}

// All targets. grid (B·nch, Ntp/32); 256 threads.
template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32)
rho_all_kernel(const float4* __restrict__ Yt4, int L, int Ntp4, int Nt,
               const int* __restrict__ idx, long long isb, long long isr,
               const float* __restrict__ w, long long wsb, long long wsr,
               int rows, int k, int off, int nch, double* __restrict__ part,
               float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane & (kGroups - 1);
  const int s = lane / kGroups;
  const int b = blockIdx.x / nch;
  const int ch = blockIdx.x - b * nch;
  const int c0 = ch * kChunkRows;
  const int nr = min(kChunkRows, rows - c0);
  const int n4 = blockIdx.y * kGroups + g;
  const int* ib = idx + b * isb + (long long)c0 * isr;
  const float* wb = w + b * wsb + (long long)c0 * wsr;
  const int sw = stage_words(k);
  int* si = reinterpret_cast<int*>(smem);
  float* sf = smem + sw;
  double* mom = reinterpret_cast<double*>(smem + (kStaged ? 2 * sw : 0));
  int ia = 0, wa = 0;
  if (kStaged) {
    ia = stage(ib, isr, k, nr, si);
    wa = stage(wb, wsr, k, nr, sf);
    cp_wait_all();
    __syncthreads();
  }

  // This warp's tile: rows t0 + 4r + s. The k-sums of the thread's 8
  // rows run side by side (8 gathers in flight a lane); a row past `rows`
  // reads the last row and is zeroed after.
  const int t0 = c0 + warp * kTileRows;
  int lr[kSlotRows];
  unsigned valid = 0;
#pragma unroll
  for (int r = 0; r < kSlotRows; ++r) {
    const int j = t0 + kSlots * r + s;
    valid |= (j < rows ? 1u : 0u) << r;
    lr[r] = min(j, rows - 1) - c0;
  }
  float4 acc[kSlotRows];
#pragma unroll
  for (int r = 0; r < kSlotRows; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q = 0; q < k; ++q) {
#pragma unroll
    for (int r = 0; r < kSlotRows; ++r) {
      const int iv = kStaged ? si[ia + lr[r] * k + q]
                             : __ldg(ib + lr[r] * isr + q);
      const float wq = kStaged ? sf[wa + lr[r] * k + q]
                               : __ldg(wb + lr[r] * wsr + q);
      const int c = min(max(iv + off, 0), L - 1);
      const float4 y = __ldg(Yt4 + (long long)c * Ntp4 + n4);
      acc[r].x = __fadd_rn(acc[r].x, __fmul_rn(wq, y.x));
      acc[r].y = __fadd_rn(acc[r].y, __fmul_rn(wq, y.y));
      acc[r].z = __fadd_rn(acc[r].z, __fmul_rn(wq, y.z));
      acc[r].w = __fadd_rn(acc[r].w, __fmul_rn(wq, y.w));
    }
  }
  // Tile moments of the thread's four targets: each sum the thread's slot
  // partial over its 8 rows, then two butterflies (tile_sum1's order);
  // the truth is read twice (for its mean, then centred) rather than held.
#pragma unroll
  for (int r = 0; r < kSlotRows; ++r)
    if (!((valid >> r) & 1u)) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float nt = (float)max(0, min(kTileRows, rows - t0));
  float4 sa = make_float4(0.f, 0.f, 0.f, 0.f), sb = sa;
#pragma unroll
  for (int r = 0; r < kSlotRows; ++r) {
    const float4 tr = truth(Yt4, valid, r, c0 + lr[r] + off, Ntp4, n4);
    add4(sa, acc[r]);
    add4(sb, tr);
  }
  const float4 ma = div4(tile_sum4(sa), nt), mb = div4(tile_sum4(sb), nt);
  float4 saa = make_float4(0.f, 0.f, 0.f, 0.f), sbb = saa, sab = saa;
#pragma unroll
  for (int r = 0; r < kSlotRows; ++r) {
    const bool ok = (valid >> r) & 1u;
    const float4 tr = truth(Yt4, valid, r, c0 + lr[r] + off, Ntp4, n4);
    const float4 da = ok ? sub4(acc[r], ma) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 db = ok ? sub4(tr, mb) : make_float4(0.f, 0.f, 0.f, 0.f);
    add4(saa, mul4(da, da));
    add4(sbb, mul4(db, db));
    add4(sab, mul4(da, db));
  }
  saa = tile_sum4(saa);
  sbb = tile_sum4(sbb);
  sab = tile_sum4(sab);
  if (s == 0 && nt > 0.f) {
    const float* fa = &ma.x;
    const float* fb = &mb.x;
    const float* faa = &saa.x;
    const float* fbb = &sbb.x;
    const float* fab = &sab.x;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      store(mom + (warp * kTargets + 4 * g + c) * kMoments,
            M{(double)nt, (double)fa[c], (double)fb[c], (double)faa[c],
              (double)fbb[c], (double)fab[c]});
  } else if (s == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      store(mom + (warp * kTargets + 4 * g + c) * kMoments,
            M{0.0, 0.0, 0.0, 0.0, 0.0, 0.0});
  }
  const int n0 = blockIdx.y * kTargets;
  finish_chunk(mom, kTargets, n0, Nt, nch, ch, (long long)b * Nt + n0,
               (long long)gridDim.x / nch * Nt, part, out);
}

// Own target (table b against series b·sy). grid (B·nch); 256 threads.
// kStaged: the chunk's tables and the whole series in shared memory (the
// gathers of one series hit 32 scattered words a warp, which the L1 takes
// one sector at a time).
template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32)
rho_own_kernel(const float* __restrict__ Y, long long sy, int L,
               const int* __restrict__ idx, long long isb, long long isr,
               const float* __restrict__ w, long long wsb, long long wsr,
               int rows, int k, int off, int nch, double* __restrict__ part,
               float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / nch;
  const int ch = blockIdx.x - b * nch;
  const int c0 = ch * kChunkRows;
  const int nr = min(kChunkRows, rows - c0);
  const float* y = Y + b * sy;
  const int* ib = idx + b * isb + (long long)c0 * isr;
  const float* wb = w + b * wsb + (long long)c0 * wsr;
  const int sw = stage_words(k);
  const int syw = series_words(L);
  int* si = reinterpret_cast<int*>(smem);
  float* sf = smem + sw;
  float* sy_ = smem + 2 * sw;
  double* mom =
      reinterpret_cast<double*>(smem + (kStaged ? 2 * sw + syw : 0));
  int ia = 0, wa = 0, ya = 0;
  if (kStaged) {
    ia = stage(ib, isr, k, nr, si);
    wa = stage(wb, wsr, k, nr, sf);
    ya = stage(y, L, L, 1, sy_);
    cp_wait_all();
    __syncthreads();
  }
  const float* ys = kStaged ? sy_ + ya : y;

  const int t0 = c0 + warp * kTileRows;
  const int j = t0 + lane;
  const bool ok = j < rows;
  float a = 0.f, tr = 0.f;
  if (ok) {
    const int lr = j - c0;
#pragma unroll 4
    for (int q = 0; q < k; ++q) {
      const int iv = kStaged ? si[ia + lr * k + q] : __ldg(ib + lr * isr + q);
      const float wq = kStaged ? sf[wa + lr * k + q] : __ldg(wb + lr * wsr + q);
      const int c = min(max(iv + off, 0), L - 1);
      a = __fadd_rn(a, __fmul_rn(wq, kStaged ? ys[c] : __ldg(y + c)));
    }
    tr = kStaged ? ys[j + off] : __ldg(y + j + off);
  }
  const float nt = (float)max(0, min(kTileRows, rows - t0));
  const M m = tile_moments1(a, tr, ok, nt);
  if (lane == 0) store(mom + warp * kMoments, m);
  finish_chunk(mom, 1, 0, 1, nch, ch, b, gridDim.x / nch, part, out);
}

// Merge each output's chunks in chunk order and take ρ.
__global__ void rho_finish_kernel(const double* __restrict__ part,
                                  long long bn_total, int nch,
                                  float* __restrict__ out) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= bn_total) return;
  M acc = load(part + u, bn_total);
  for (int c = 1; c < nch; ++c)
    acc = merge(acc, load(part + (long long)c * kMoments * bn_total + u,
                          bn_total));
  out[u] = rho_of(acc);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// All-targets form. Yt: (L, ntp) float32, ntp a multiple of 32, target n in
// column n (columns past Nt zero). idx, w: table b row j slot q at
// b·sb + j·sr + q (their own strides). out (B, Nt). part: scratch of
// nch·6·B·Nt doubles when nch = ⌈rows / 256⌉ > 1 (unused otherwise).
// staged: stage the tables in shared memory (the wrapper's rule: k ≤ 32).
// Returns the launch's cudaGetLastError().
extern "C" int lookup_rho_all_launch(const float* Yt, int L, int ntp, int Nt,
                                     const int* idx, long long isb,
                                     long long isr, const float* w,
                                     long long wsb, long long wsr, int B,
                                     int rows, int k, int off, int staged,
                                     double* part, float* out, void* stream) {
  if (ntp % kTargets != 0 || rows < 1 || k < 1 || B < 1 || Nt < 1)
    return (int)cudaErrorInvalidValue;
  const int nch = (rows + kChunkRows - 1) / kChunkRows;
  const size_t mom = (size_t)kWarps * kTargets * kMoments * 8;
  const size_t smem = (staged ? (size_t)2 * stage_words(k) * 4 : 0) + mom;
  const dim3 grid((unsigned)(B * nch), (unsigned)(ntp / kTargets));
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (staged) {
    err = set_smem(rho_all_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    rho_all_kernel<true><<<grid, kWarps * 32, smem, st>>>(
        reinterpret_cast<const float4*>(Yt), L, ntp / 4, Nt, idx, isb, isr,
        w, wsb, wsr, rows, k, off, nch, part, out);
  } else {
    err = set_smem(rho_all_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    rho_all_kernel<false><<<grid, kWarps * 32, smem, st>>>(
        reinterpret_cast<const float4*>(Yt), L, ntp / 4, Nt, idx, isb, isr,
        w, wsb, wsr, rows, k, off, nch, part, out);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || nch == 1) return (int)err;
  const long long bn = (long long)B * Nt;
  rho_finish_kernel<<<(unsigned)((bn + 255) / 256), 256, 0, st>>>(part, bn,
                                                                  nch, out);
  return (int)cudaGetLastError();
}

// Own-target form: table b against the series at Y + b·sy (sy = 0: every
// table against one series, the all-targets form's Nt = 1). out (B,).
// part: nch·6·B doubles when nch > 1. staged: stage the tables and the
// series in shared memory (the wrapper's rule: k ≤ 32 and L ≤ 12,288).
// Returns cudaGetLastError().
extern "C" int lookup_rho_own_launch(const float* Y, long long sy, int L,
                                     const int* idx, long long isb,
                                     long long isr, const float* w,
                                     long long wsb, long long wsr, int B,
                                     int rows, int k, int off, int staged,
                                     double* part, float* out, void* stream) {
  if (rows < 1 || k < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const int nch = (rows + kChunkRows - 1) / kChunkRows;
  const size_t mom = (size_t)kWarps * kMoments * 8;
  const size_t smem =
      (staged ? (size_t)(2 * stage_words(k) + series_words(L)) * 4 : 0) + mom;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (staged) {
    err = set_smem(rho_own_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    rho_own_kernel<true><<<(unsigned)(B * nch), kWarps * 32, smem, st>>>(
        Y, sy, L, idx, isb, isr, w, wsb, wsr, rows, k, off, nch, part, out);
  } else {
    err = set_smem(rho_own_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    rho_own_kernel<false><<<(unsigned)(B * nch), kWarps * 32, smem, st>>>(
        Y, sy, L, idx, isb, isr, w, wsb, wsr, rows, k, off, nch, part, out);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || nch == 1) return (int)err;
  rho_finish_kernel<<<(unsigned)((B + 255) / 256), 256, 0, st>>>(part, B,
                                                                 nch, out);
  return (int)cudaGetLastError();
}
