// Fused all-kNN over one series: the distances and the k-best selection in
// one kernel, the (Lp, Lp) distance matrix never in global memory.
//
// Replaces the Pallas TPU kernel repro/kernels/knn_fused.py::_kernel
// (wrapper all_knn_fused, reached by ops.all_knn(fused=True)). For every
// embedded row i < Lp it emits the k nearest columns j < Lp of
//     D[i, j] = Σ_{k<E} (x[i+kτ] − x[j+kτ])²,
// the strict chain of kbest.cuh (each subtraction, square and addition
// rounded on its own, lags in order), in (value, index) order; self
// (exclude_self) and columns past the cap mx enter as +inf with their real
// index; the roots are taken after the selection. Unlike the TPU wrapper it
// does not mean-center the series: the port's pairwise kernel and the
// reference's ref.pairwise_distances do not either, so this kernel's tables
// are bit-equal to pairwise_dist.cu followed by topk.cu.
//
// What bounds it on the H100: float32 ALU work. Each distance adds its E
// squares in order (E·Lp² additions, no FMA, for the bits), and a square
// (x[i'] − x[j'])² serves every pair on its diagonal, so the least work is
// a sub and a mul per pair (i', j') besides: (E + 2)·Lp² operations (2.2
// GFLOP at L = 10,000, E = 20, ≈0.033 ms at 67 TFLOP/s; the strict chain
// taken pair by pair is 3·E·Lp²). The traffic is the series and the
// tables, L·4 + Lp·k·8 bytes (1.7 MB there), where the two-kernel path
// writes and reads 4·Lp² bytes (398 MB) of distances.
//
// Two designs, picked by the wrapper (knn_fused.route); both bit-equal.
//  knn_fused_select_kernel (k ≤ 32, E ≤ 32). The first design gave one
//  warp one row, loaded the row's value and the column's from shared
//  memory for every lag term (two loads for 3 operations), offered every
//  group of 32 columns to a list in shared memory, and staged the whole
//  series in every block (the L + 32·k ceiling). Here:
//   - a warp carries R rows i0 + rτ (6 up to E = 20, 4 above; the rows
//     split by residue mod τ), and lane b of a group takes the diagonal of
//     columns b + rτ: the R distances then share their squares, since
//     (x[i0 + rτ + eτ] − x[b + rτ + eτ])² is the lane's s[e + r] for
//     s[e'] = (x[i0 + e'τ] − x[b + e'τ])². A lane forms E + R − 1 squares
//     (a sub and a mul each) and each row adds its E in lag order (the
//     strict chain's bits): 2(E + R − 1) + R·E operations for R·E terms,
//     170 for 120 at E = 20, where the strict chain alone takes 360. The
//     rows' lag values x[i0 + e'τ] sit in registers, and the lane's are
//     E + R − 1 shared loads a group;
//   - the warps of a block split the diagonals into S slices (S from the
//     shape: two blocks an SM or more) and stream them through a cp.async
//     double buffer of tiles of C + (E + R − 2)τ floats, so no block holds
//     the series and no length is refused;
//   - selection is buffered (warp_select.cuh's sorts): a first pass over
//     the 64 diagonals around the warp's rows (the series' near neighbours
//     in time, at a cost of 2 groups) gives each row a threshold, the k-th
//     of those 64 values; the walk appends only keys under it to a
//     96-slot buffer per (warp, row) by one ballot, and a buffer past 64 is
//     sorted and cut to its k first (wsel::compact), which tightens the
//     threshold to its k-th key. Cut to 32 (as knn_multi_e), a buffer
//     refilled past half on almost every later group and was sorted
//     again; cut to k with room for 64 it is sorted a few times a row. A
//     full first pass, as knn_multi_e's, would double the sums that bound
//     this kernel.
//     At the end each slice's buffer holds its k first keys, and the S
//     sorted lists of a row are merged (wsel::merge32). The (value, index)
//     order is total, so the k first of any partition are the same bits.
//  knn_fused_kernel (any k): one warp a row, each candidate that beats the
//  row's k-th best inserted into a shared-memory list by the whole warp
//  (kbest::warp_offer); the series is staged in shared memory when it fits
//  beside 16 warps' lists, and read from global memory otherwise.
#include "kbest.cuh"
#include "warp_select.cuh"

namespace {

template <bool kStaged>
__global__ void knn_fused_kernel(const float* __restrict__ x, int L, int Lp,
                                 int E, int tau, int k, int mx,
                                 int exclude_self, float* __restrict__ out_d,
                                 int* __restrict__ out_i) {
  extern __shared__ float smem[];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sd = smem + warp * k;
  int* si = reinterpret_cast<int*>(smem + W * k) + warp * k;
  float* xsh = smem + 2 * W * k;
  if (kStaged) {
    for (int u = threadIdx.x; u < L; u += blockDim.x) xsh[u] = x[u];
    __syncthreads();
  }
  const float* xs = kStaged ? xsh : x;
  const int i = blockIdx.x * W + warp;  // this warp's row
  if (i >= Lp) return;  // whole warp, after the block's only barrier

  kbest::warp_init(sd, si, k);
  for (int jb = 0; jb < Lp; jb += 32) {
    const int j = jb + lane;
    const bool live = j < Lp;
    const int jr = live ? j : 0;  // in-range read for idle lanes
    float acc = 0.f;
    for (int e = 0; e < E; ++e)
      acc = kbest::add_sq(acc, xs[i + e * tau], xs[jr + e * tau]);
    const bool masked = j > mx || (exclude_self && j == i);
    kbest::warp_offer(sd, si, k, live, masked ? INFINITY : acc, j);
  }
  const size_t base = (size_t)i * k;
  for (int q = lane; q < k; q += 32) {
    out_d[base + q] = __fsqrt_rn(sd[q]);
    out_i[base + q] = si[q];
  }
}

constexpr int kSelWarps = 8;  // warps a block of the selection kernel
constexpr int kBuf = 96;      // buffer slots per (warp, row)

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// The warp's rows are i0 + rτ (r < kR) and lane b of a group takes the
// diagonal of columns b + rτ: row r's distance at that column is
//     Σ_{e<E} (x[i0 + (e+r)τ] − x[b + (e+r)τ])² = Σ_{e<E} s[e + r],
// with s[e'] = fl(fl(x[i0 + e'τ] − x[b + e'τ])²) for e' < E + kR − 1, so
// one lane forms E + kR − 1 squares for kR chains, and each chain adds its
// E squares in lag order from 0: the strict chain's bits.

// Row r's key at column c = b + rτ: NaN past the row (it passes no
// threshold), +inf past the cap or at self.
__device__ __forceinline__ float masked(float v, int c, int Lp, int mx,
                                        bool self) {
  return (c < 0 || c >= Lp) ? NAN : (c > mx || self) ? INFINITY : v;
}

// One group of 32 diagonals (one a lane, base column b): the kR chains,
// then each row's keys under its threshold appended to its buffer; a
// buffer past 64 is compacted to its k first. xb: the lane's x[b + e'τ]
// in shared memory at stride τ. kMask: some column of the group lies
// outside [0, min(mx, Lp - 1)] or is self.
template <int kE, int kR, bool kMask>
__device__ __forceinline__ void walk_group(
    const float* xb, const float (&xi)[kE + kR - 1], int E, int tau, int b,
    int i0, int Lp, int mx, int exclude_self, int k, unsigned lt, float* tv,
    int* ti, int* cnt, float* bufv, int* bufi) {
  float sq[kE + kR - 1];
#pragma unroll
  for (int u = 0; u < kE + kR - 1; ++u) {
    if (u >= E + kR - 1) break;
    const float d = __fsub_rn(xi[u], xb[u * tau]);
    sq[u] = __fmul_rn(d, d);
  }
  float acc[kR];  // the kR chains side by side, lag by lag
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = 0.f;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    if (e >= E) break;
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = __fadd_rn(acc[r], sq[e + r]);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float v = acc[r];
    const int c = b + r * tau;
    if (kMask) v = masked(v, c, Lp, mx, exclude_self && b == i0);
    // v ≤ tv holds every key that beats (tv, ti): one compare and one
    // vote a row when no lane's key can pass, which is most groups.
    if (!__any_sync(kbest::kFull, v <= tv[r])) continue;
    const bool take = kbest::before(v, c, tv[r], ti[r]);
    const unsigned bal = __ballot_sync(kbest::kFull, take);
    if (take) {
      const int pos = cnt[r] + __popc(bal & lt);
      bufv[r * kBuf + pos] = v;
      bufi[r * kBuf + pos] = c;
    }
    cnt[r] += __popc(bal);
    if (cnt[r] > kBuf - 32) {
      __syncwarp();
      const wsel::Key t = wsel::compact(bufv + r * kBuf, bufi + r * kBuf,
                                        cnt[r], k);
      tv[r] = t.v;
      ti[r] = t.i;
      cnt[r] = k;  // keys past the k-th can no longer be chosen
    }
  }
}

// The first row of row group q: rows split by residue mod τ into runs of
// kR consecutive members (M runs a residue); Lp (no row) past the last.
__device__ __forceinline__ int group_row(int q, int M, int R, int tau,
                                         int Lp) {
  const int rho = q / M;
  return rho < tau ? rho + (q - rho * M) * R * tau : Lp;
}

// grid ⌈τ·M / (kSelWarps/S)⌉ blocks of kSelWarps warps, M = ⌈⌈Lp/τ⌉/kR⌉:
// warp w takes row group blockIdx·(kSelWarps/S) + w / S and diagonal slice
// w % S. Diagonals b run over [-(kR-1)τ, Lp); xpad[u] = x[u - (kR-1)τ]
// (zero outside x). Shared memory: two tiles of tw floats (C diagonals
// and their (E + kR - 2)τ lags), then per warp and row a kBuf-slot buffer
// of values and one of indices.
template <int kE, int kR>
__global__ void __launch_bounds__(kSelWarps * 32, 2)
knn_fused_select_kernel(const float* __restrict__ xpad, int Lp, int E,
                        int tau, int k, int mx, int exclude_self, int S,
                        int C, int tw, int ntiles, int M,
                        float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) float sel_smem[];
  constexpr int kN = kE + kR - 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = warp / S;
  const int sl = warp - rg * S;
  const int RG = kSelWarps / S;
  const int i0 = group_row(blockIdx.x * RG + rg, M, kR, tau, Lp);
  const int pre = (kR - 1) * tau;  // diagonal b sits at xpad[b + pre]
  const int G = C / (32 * S);  // groups of 32 diagonals a warp per tile
  float* tiles = sel_smem;
  float* bufv = sel_smem + 2 * tw + warp * kR * kBuf;
  int* bufi = reinterpret_cast<int*>(sel_smem + 2 * tw +
                                     kSelWarps * kR * kBuf) +
              warp * kR * kBuf;
  unsigned lt;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));

  // Start the first tile's copy, then the rows' lag values and pass 1.
  for (int u = threadIdx.x; u < tw / 4; u += blockDim.x)
    cp16(tiles + 4 * u, xpad + 4 * u);
  asm volatile("cp.async.commit_group;\n" ::);

  float xi[kN];  // x[i0 + e'τ], warp-uniform
  const int ir = min(i0, Lp - 1);
#pragma unroll
  for (int u = 0; u < kN; ++u)
    xi[u] = u < E + kR - 1 ? __ldg(xpad + pre + ir + u * tau) : 0.f;
  // Pass 1: each row's threshold, the k-th of its 64 columns b + rτ for
  // the diagonals b in [w0, w0 + 64) around the rows (masked ones +inf).
  const int w0 = max(-pre, min(i0 - 32, Lp - 64));
  float tv[kR];
  int ti[kR], cnt[kR];
  {
    float s0[kN], s1[kN];
    const int b0 = w0 + lane, b1 = w0 + 32 + lane;
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      if (u >= E + kR - 1) break;
      const float d0 = __fsub_rn(xi[u], __ldg(xpad + pre + b0 + u * tau));
      const float d1 = __fsub_rn(xi[u], __ldg(xpad + pre + b1 + u * tau));
      s0[u] = __fmul_rn(d0, d0);
      s1[u] = __fmul_rn(d1, d1);
    }
    float a0[kR], a1[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) a0[r] = a1[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (e >= E) break;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        a0[r] = __fadd_rn(a0[r], s0[e + r]);
        a1[r] = __fadd_rn(a1[r], s1[e + r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float v0 = a0[r], v1 = a1[r];
      const int c0 = b0 + r * tau, c1 = b1 + r * tau;
      v0 = (c0 < 0 || c0 >= Lp || c0 > mx || (exclude_self && b0 == i0))
               ? INFINITY : v0;
      v1 = (c1 < 0 || c1 >= Lp || c1 > mx || (exclude_self && b1 == i0))
               ? INFINITY : v1;
      tv[r] = wsel::kth_of_64(v0, v1, k);
      ti[r] = kbest::kEmpty;
      cnt[r] = 0;
    }
  }

  // Pass 2: the tiles, double-buffered.
  const int hi = min(mx, Lp - 1) - pre;  // the last b whose columns all pass
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      float* nxt = tiles + ((t + 1) & 1) * tw;
      const float* src = xpad + (size_t)(t + 1) * C;
      for (int u = threadIdx.x; u < tw / 4; u += blockDim.x)
        cp16(nxt + 4 * u, src + 4 * u);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* cur = tiles + (t & 1) * tw;
    for (int g = 0; g < G; ++g) {
      const int lc = (sl * G + g) * 32;  // the group's first diagonal here
      const int jb = t * C + lc - pre;   // ... as a column of row 0
      if (jb >= Lp) break;
      const int b = jb + lane;
      const bool plain = jb >= 0 && jb + 31 <= hi &&
                         !(exclude_self && jb <= i0 && i0 <= jb + 31);
      if (plain)
        walk_group<kE, kR, false>(cur + lc + lane, xi, E, tau, b, i0, Lp, mx,
                                  exclude_self, k, lt, tv, ti, cnt, bufv,
                                  bufi);
      else
        walk_group<kE, kR, true>(cur + lc + lane, xi, E, tau, b, i0, Lp, mx,
                                 exclude_self, k, lt, tv, ti, cnt, bufv,
                                 bufi);
    }
    __syncthreads();  // every warp is done with this buffer
  }

  // Each slice's 32 first keys a row, sorted, in its buffer's first slots.
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    __syncwarp();
    wsel::compact(bufv + r * kBuf, bufi + r * kBuf, cnt[r], k);
  }
  if (S == 1) {  // each warp writes its own rows
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = i0 + r * tau;
      if (i < Lp && lane < k) {
        out_d[(size_t)i * k + lane] = __fsqrt_rn(bufv[r * kBuf + lane]);
        out_i[(size_t)i * k + lane] = bufi[r * kBuf + lane];
      }
    }
    return;
  }
  // Row q of the block: the S lists of its row group merged by warp q % 8.
  __syncthreads();
  const float* bv = sel_smem + 2 * tw;
  const int* bi =
      reinterpret_cast<const int*>(sel_smem + 2 * tw + kSelWarps * kR * kBuf);
  for (int q = warp; q < RG * kR; q += kSelWarps) {
    const int g = q / kR, r = q - g * kR;
    const int i = group_row(blockIdx.x * RG + g, M, kR, tau, Lp) + r * tau;
    const int base = g * S * kR * kBuf + r * kBuf;  // slice 0's list
    float v = bv[base + lane];
    int ix = bi[base + lane];
    for (int s = 1; s < S; ++s)
      wsel::merge32(v, ix, bv[base + s * kR * kBuf + lane],
                    bi[base + s * kR * kBuf + lane]);
    if (i < Lp && lane < k) {
      out_d[(size_t)i * k + lane] = __fsqrt_rn(v);
      out_i[(size_t)i * k + lane] = ix;
    }
  }
}

template <int kE, int kR>
cudaError_t launch_select(const float* xpad, int Lp, int E, int tau, int k,
                          int mx, int exclude_self, int S, int C, int tw,
                          int pre, float* out_d, int* out_i,
                          cudaStream_t stream) {
  if (pre != (kR - 1) * tau || tw < C + (E + kR - 2) * tau)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * tw * 4 + (size_t)kSelWarps * kR * kBuf * 8;
  cudaError_t err = cudaFuncSetAttribute(
      knn_fused_select_kernel<kE, kR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (Lp + pre + C - 1) / C;
  const int M = ((Lp + tau - 1) / tau + kR - 1) / kR;
  const int groups_per_block = kSelWarps / S;
  const int blocks = (tau * M + groups_per_block - 1) / groups_per_block;
  knn_fused_select_kernel<kE, kR><<<blocks, kSelWarps * 32, smem, stream>>>(
      xpad, Lp, E, tau, k, mx, exclude_self, S, C, tw, ntiles, M, out_d,
      out_i);
  return cudaGetLastError();
}

}  // namespace

// x: (L,) float32. out_d, out_i: (Lp, k), Lp = L - (E-1)·tau. mx: the
// inclusive column cap (Lp - 1 for none). One warp per row,
// warps_per_block rows per block; staged: copy the series into shared
// memory beside the lists (L + 2·k·warps_per_block floats). Returns the
// launch's cudaGetLastError().
extern "C" int knn_fused_launch(const float* x, int L, int E, int tau, int k,
                                int mx, int exclude_self, int warps_per_block,
                                int staged, float* out_d, int* out_i,
                                void* stream) {
  const int Lp = L - (E - 1) * tau;
  if (Lp <= 0 || E < 1 || k < 1 || k > Lp || warps_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((staged ? (size_t)L : 0) + 2 * (size_t)k * warps_per_block) * 4;
  const int blocks = (Lp + warps_per_block - 1) / warps_per_block;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (staged) {
    err = cudaFuncSetAttribute(knn_fused_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    knn_fused_kernel<true><<<blocks, warps_per_block * 32, smem, st>>>(
        x, L, Lp, E, tau, k, mx, exclude_self, out_d, out_i);
  } else {
    err = cudaFuncSetAttribute(knn_fused_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    knn_fused_kernel<false><<<blocks, warps_per_block * 32, smem, st>>>(
        x, L, Lp, E, tau, k, mx, exclude_self, out_d, out_i);
  }
  return (int)cudaGetLastError();
}

// The selection kernel: xpad[u] = x[u - pre] for pre = (R-1)·tau (zero
// outside x), R = 6 for E ≤ 20, 4 above, 16-byte aligned and
// at least ⌈(Lp + pre)/C⌉·C + tw + 64 + 2·pre floats (tw ≥ C + (E+R-2)·tau,
// a multiple of 4; C a multiple of 32·S); S column slices (1, 2, 4 or 8);
// k ≤ 32, E ≤ 32, k ≤ Lp. Returns cudaGetLastError().
extern "C" int knn_fused_select_launch(const float* xpad, int L, int E,
                                       int tau, int k, int mx,
                                       int exclude_self, int S, int C,
                                       int tw, int pre, float* out_d,
                                       int* out_i, void* stream) {
  const int Lp = L - (E - 1) * tau;
  if (Lp <= 0 || E < 1 || E > 32 || k < 1 || k > 32 || k > Lp ||
      (S != 1 && S != 2 && S != 4 && S != 8) || C % (32 * S) != 0 ||
      tw % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      E <= 4    ? launch_select<4, 6>(xpad, Lp, E, tau, k, mx, exclude_self,
                                      S, C, tw, pre, out_d, out_i, s)
      : E <= 8  ? launch_select<8, 6>(xpad, Lp, E, tau, k, mx, exclude_self,
                                      S, C, tw, pre, out_d, out_i, s)
      : E <= 12 ? launch_select<12, 6>(xpad, Lp, E, tau, k, mx, exclude_self,
                                       S, C, tw, pre, out_d, out_i, s)
      : E <= 16 ? launch_select<16, 6>(xpad, Lp, E, tau, k, mx, exclude_self,
                                       S, C, tw, pre, out_d, out_i, s)
      : E <= 20 ? launch_select<20, 6>(xpad, Lp, E, tau, k, mx, exclude_self,
                                       S, C, tw, pre, out_d, out_i, s)
      : E <= 24 ? launch_select<24, 4>(xpad, Lp, E, tau, k, mx, exclude_self,
                                       S, C, tw, pre, out_d, out_i, s)
                : launch_select<32, 4>(xpad, Lp, E, tau, k, mx, exclude_self,
                                       S, C, tw, pre, out_d, out_i, s);
  return (int)err;
}
