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
//     with the dt new columns [Lp_old, Lp_new), in the order of the
//     squared distances the cold build compared (the strict chain of
//     kbest.cuh). The list keeps only their roots; where a comparison
//     needs a value, it is recomputed from the series by that chain, so it
//     is those bits. A stored slot holding inf (a level with
//     fewer candidates than k) enters as +inf with the distinct index
//     kSentinel + slot: its old index may name a column that is valid now.
//     When inf slots survive the merge they are rewritten to the cold
//     build's pattern (self at the first, then the slot number), as
//     ref.normalize_garbage does.
//   - a new row Lp_old <= i < Lp_new scans every column as the cold build
//     does (columns past Lp_new - 1, and self, as +inf with their index).
//   - a row i >= Lp_new is padding: inf / -1.
//
// What bounds it on the H100: moving the tables, (N·E_max·k·8 B) read at
// L_old and written at L_new (≈1.7 GB at 154 × 20 × 1600 × 22, ≈0.5 ms at
// 3.35 TB/s). The least arithmetic is the chains of the pairs some level
// compares: every old row against the columns new at its level, every new
// row against every column, each chain carried once to its deepest level
// (0.30 GFLOP at dt = 1 and 2.1 at dt = 64 there, by chip_smoke.py's
// append_ops; under 0.04 ms at 67 TFLOP/s). The stored candidates' values
// are not part of it: their roots order them (below).
//
// Two designs, picked by the wrapper by shape; both give the same bits.
//  knn_append_stream_kernel (k ≤ 32, E_max ≤ 32): one launch, two kinds
//  of block. The series is staged once per block in shared memory.
//   - A tile block owns 128 rows of one series and walks the levels. A
//     level's rows are contiguous in both tables, so the tile's old rows
//     come in by cp.async (16-byte copies where aligned), the next level's
//     while this one merges, and go out by coalesced stores: no lane idles
//     at k = 22. One thread merges one row in place in shared memory: its
//     stored list is checked to be in (value, index) order (sorted by
//     insertion if not), then the new columns' strict chains, sixteen side
//     by side, are compared with an upper bound on the k-th slot's value,
//     and only the few under it are rooted and placed, by a binary search.
//     The list keeps roots r = sqrt_rn(v), and sqrt_rn is monotone, so for
//     two keys r_a < r_b ⇒ v_a < v_b and r_a > r_b ⇒ v_a > v_b; only equal
//     roots need the values, which are then recomputed by the strict chain
//     from the indices (a sentinel's value is +inf). The bound comes from
//     the k-th root alone (sqrt_rn(v) = r ⇒ v < fl↑(r²) + 3 ulps), so no
//     stored candidate's value is recomputed but on equal roots.
//   - A walk block gives one warp to each row that is new at some level
//     ([L_old − (E_max−1)·τ, L_new)): it walks the columns, 32 at a time,
//     accumulating the lag sum level by level, and selects at each level
//     where the row is new, as knn_multi_e.cu's selection does: a first
//     walk bounds each level's k-th nearest (the k-th of each lane's two
//     smallest), a second appends the lanes under the bound to a 64-slot
//     buffer (ballot and popc), sorted with shuffles and cut to its k
//     first when past half full (warp_select.cuh). The new levels' state
//     sits in registers, unrolled by a template on their count (up to
//     ⌈dt/τ⌉). The walk blocks come first in the grid so that they run
//     beside the tiles.
//  knn_append_kernel (any k a block's shared memory holds): one warp owns
//  one (series, level, row) and a k-slot list in shared memory kept in
//  (value, index) order (kbest::warp_offer). A stored list is already in
//  that order, so it is loaded as it is, its values recomputed by the
//  chain, and only the dt new columns are offered; a list that is not in
//  order is offered slot by slot instead. New rows scan every column, level
//  by level.
#include <stdint.h>

#include "kbest.cuh"
#include "warp_select.cuh"

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

// ----------------------------------------------------- the stream design

constexpr int kStreamThreads = 128;  // tile rows; walk rows are 4 warps
constexpr int kBuf = 64;             // buffer slots per (warp, new level)
constexpr int kGroup = 16;           // new columns an old row takes at once

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// n 4-byte words from global src to shared dst (16-byte aligned), by the
// whole block: 16-byte copies when src is 16-byte aligned too.
__device__ __forceinline__ void copy_in(void* dst, const void* src, int n) {
  const int tid = threadIdx.x;
  int done = 0;
  if (((uintptr_t)src & 15) == 0) {
    done = n & ~3;
    for (int f = tid * 4; f < done; f += kStreamThreads * 4)
      cp_async16(static_cast<char*>(dst) + 4 * f,
                 static_cast<const char*>(src) + 4 * f);
  }
  for (int f = done + tid; f < n; f += kStreamThreads)
    cp_async4(static_cast<char*>(dst) + 4 * f,
              static_cast<const char*>(src) + 4 * f);
}

// One row i at level e of one series, staged in shared memory (xs).
struct Row {
  const float* xs;
  int i, e, tau;

  // The strict chain of column j against row i.
  __device__ __forceinline__ float chain(int j) const {
    float acc = 0.f;
    for (int l = 0; l <= e; ++l)
      acc = kbest::add_sq(acc, xs[i + l * tau], xs[j + l * tau]);
    return acc;
  }

  // The squared distance behind a list entry: +inf for a sentinel.
  __device__ __forceinline__ float value(int j) const {
    return j >= kSentinel ? INFINITY : chain(j);
  }
};

// An upper bound on the squared distance v behind a stored root r:
// sqrt_rn(v) = r gives v ≤ (r + ulp(r)/2)² < r² + 2·ulp(r²), so fl↑(r²)
// three ulps up bounds it (+inf for an empty slot).
__device__ __forceinline__ float root_bound(float r) {
  if (!(r < INFINITY)) return INFINITY;
  const int b = __float_as_int(__fmul_ru(r, r)) + 3;
  return b >= 0x7f800000 ? INFINITY : __int_as_float(b);
}

// Merge row r's stored list (k roots d, indices ix, in shared memory) with
// the new columns [c0, c1), in place, then normalize its garbage slots.
// Inlined, with the row by value: a row passed by reference lives in
// local memory and is reloaded after every store to the list.
__device__ __forceinline__ void merge_row(const Row r, float* __restrict__ d,
                                          int* __restrict__ ix, int k,
                                          int c0, int c1) {
  // The (value, index) order of two entries by their roots, the values
  // deciding only equal roots.
  auto before = [&](float ra, int ja, float rb, int jb) {
    if (ra != rb) return ra < rb;
    return kbest::before(r.value(ja), ja, r.value(jb), jb);
  };
  bool down = false, tie = false;
  float rp = -INFINITY;
  for (int q = 0; q < k; ++q) {
    float rq = d[q];
    if (!isfinite(rq)) {  // no neighbour: +inf with a distinct index
      rq = INFINITY;
      d[q] = rq;
      ix[q] = kSentinel + q;
    }
    down |= rq < rp;
    tie |= rq == rp;
    rp = rq;
  }
  // A list out of (value, index) order (none that all_knn_multi_e or this
  // kernel builds) is sorted by insertion; equal roots are checked so.
  if (down || tie) {
    for (int q = 1; q < k; ++q) {
      const float rq = d[q];
      const int jq = ix[q];
      if (!before(rq, jq, d[q - 1], ix[q - 1])) continue;
      int p = q;
      do {
        d[p] = d[p - 1];
        ix[p] = ix[p - 1];
        --p;
      } while (p > 0 && before(rq, jq, d[p - 1], ix[p - 1]));
      d[p] = rq;
      ix[p] = jq;
    }
  }
  // Each new column against a bound on the k-th slot's value; the few
  // under it are rooted and placed by the root rule (a binary search).
  // A new column's index exceeds every stored one, so (value, index)
  // order is the cold build's.
  float bound = root_bound(d[k - 1]);
  auto offer = [&](float v, int c) {
    const float rc = __fsqrt_rn(v);
    if (!before(rc, c, d[k - 1], ix[k - 1])) return;
    int lo = 0, hi = k - 1;  // entries below lo precede it, hi's does not
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (before(d[mid], ix[mid], rc, c))
        lo = mid + 1;
      else
        hi = mid;
    }
    for (int q = k - 1; q > lo; --q) {
      d[q] = d[q - 1];
      ix[q] = ix[q - 1];
    }
    d[lo] = rc;
    ix[lo] = c;
    bound = root_bound(d[k - 1]);
  };
  // kGroup columns' chains side by side; each lane then offers only its
  // own under the bound, one per pass of a loop it leaves when they are in
  // (a warp pays for its lanes' largest count, not for every lane's).
  int c = c0;
  for (; c + kGroup <= c1; c += kGroup) {
    float a[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) a[g] = 0.f;
    for (int l = 0; l <= r.e; ++l) {
      const float xi = r.xs[r.i + l * r.tau];
      const float* xc = r.xs + c + l * r.tau;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) a[g] = kbest::add_sq(a[g], xi, xc[g]);
    }
    unsigned pend = 0;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) pend |= (a[g] <= bound ? 1u : 0u) << g;
    while (pend) {
      const int q = __ffs(pend) - 1;
      pend &= pend - 1;
      float v = a[0];
#pragma unroll
      for (int g = 1; g < kGroup; ++g) v = q == g ? a[g] : v;
      if (v <= bound) offer(v, c + q);
    }
  }
  for (; c < c1; ++c) {
    const float v = r.chain(c);
    if (v <= bound) offer(v, c);
  }
  // The finite slots are a prefix of the list; the rest is garbage.
  int nfin = 0;
  for (int q = 0; q < k; ++q) nfin += isfinite(d[q]) ? 1 : 0;
  for (int q = nfin; q < k; ++q) ix[q] = q == nfin ? r.i : q;
}

// A walk warp's row i of series s, new at levels [e_lo, e_hi], at most
// kSel of them. Two walks of every column, as knn_multi_e.cu's selection:
// pass 1 keeps each lane's two smallest values per new level, whose k-th
// of 64 bounds the level's k-th nearest from above; pass 2 appends the
// lanes under that bound to the level's buffer and merges a buffer past
// half full into its k first. The per-level state sits in registers, the
// new levels unrolled (a template on kSel), the levels below e_lo in a
// plain loop. Then each level's k first, rooted.
template <int kSel>
__device__ __forceinline__ void walk_row(
    const float* __restrict__ xs, int s, int i, int L_old, int L_new,
    int E_max, int tau, int k, float* __restrict__ bufv,
    int* __restrict__ bufi, float* __restrict__ out_d,
    int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int e_lo = i >= L_old ? 0 : (L_old - i + tau - 1) / tau;
  const int e_hi = min(E_max - 1, (L_new - 1 - i) / tau);
  const int nq = e_hi - e_lo + 1;  // ≤ kSel
  if (nq < 1) return;  // (τ > 1) new at no level
  float m1[kSel], m2[kSel];
#pragma unroll
  for (int q = 0; q < kSel; ++q) m1[q] = m2[q] = INFINITY;
  for (int jb = 0; jb < L_new; jb += 32) {
    const int j = jb + lane;
    const bool live = j < L_new;
    float acc = 0.f;
    for (int e = 0; e < e_lo; ++e)
      acc = kbest::add_sq(acc, xs[i + e * tau], xs[j + e * tau]);
#pragma unroll
    for (int q = 0; q < kSel; ++q) {
      if (q >= nq) break;
      const int e = e_lo + q;
      acc = kbest::add_sq(acc, xs[i + e * tau], xs[j + e * tau]);
      // A masked column or a lane past the series raises no bound.
      const float v = !live || j >= L_new - e * tau || j == i ? INFINITY
                                                            : acc;
      m2[q] = fminf(m2[q], fmaxf(m1[q], v));
      m1[q] = fminf(m1[q], v);
    }
  }
  float tv[kSel];  // each new level's threshold (tv, ti) and buffer fill
  int ti[kSel], cnt[kSel];
#pragma unroll
  for (int q = 0; q < kSel; ++q) {
    tv[q] = q < nq ? wsel::kth_of_64(m1[q], m2[q], k) : 0.f;
    ti[q] = kbest::kEmpty;
    cnt[q] = 0;
  }
  unsigned lt;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));
  for (int jb = 0; jb < L_new; jb += 32) {
    const int j = jb + lane;
    const bool live = j < L_new;
    float acc = 0.f;
    for (int e = 0; e < e_lo; ++e)
      acc = kbest::add_sq(acc, xs[i + e * tau], xs[j + e * tau]);
    unsigned full = 0;  // the levels whose buffer must be merged
#pragma unroll
    for (int q = 0; q < kSel; ++q) {
      if (q >= nq) break;
      const int e = e_lo + q;
      acc = kbest::add_sq(acc, xs[i + e * tau], xs[j + e * tau]);
      // Past the level's last row, and self, are +inf with their index; a
      // lane past the series offers NaN, which passes no threshold.
      const float v = !live ? NAN
                      : (j >= L_new - e * tau || j == i) ? INFINITY : acc;
      const bool take = kbest::before(v, j, tv[q], ti[q]);
      const unsigned b = __ballot_sync(kbest::kFull, take);
      if (take) {
        const int pos = q * kBuf + cnt[q] + __popc(b & lt);
        bufv[pos] = v;
        bufi[pos] = j;
      }
      cnt[q] += __popc(b);
      full |= (cnt[q] > kBuf - 32 ? 1u : 0u) << q;
    }
    if (full) {  // keep the k first: the rest trail the k-th
#pragma unroll
      for (int q = 0; q < kSel; ++q) {
        if (!((full >> q) & 1)) continue;
        __syncwarp();
        const wsel::Key t = wsel::compact(bufv + q * kBuf, bufi + q * kBuf,
                                          cnt[q], k);
        tv[q] = t.v;
        ti[q] = t.i;
        cnt[q] = k;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kSel; ++q) {
    if (q >= nq) break;
    __syncwarp();
    wsel::compact(bufv + q * kBuf, bufi + q * kBuf, cnt[q], k);
    if (lane < k) {
      const size_t base = (((size_t)s * E_max + e_lo + q) * L_new + i) * k;
      out_d[base + lane] = __fsqrt_rn(bufv[q * kBuf + lane]);
      out_i[base + lane] = bufi[q * kBuf + lane];
    }
  }
}

// grid: N·walk_per walk blocks (4 rows each from walk_row0), then
// N·row_tiles tile blocks (128 rows each); kStreamThreads threads. Shared
// memory: the series (xs_len floats, zero past Lx), then either two
// (128·k) tiles of roots and of indices, or per warp nsel buffers of kBuf
// values and of kBuf indices.
template <int kSel>
__global__ void __launch_bounds__(kStreamThreads)
knn_append_stream_kernel(const float* __restrict__ xpad, int N, int Lx,
                         int xs_len, int L_old, int L_new, int E_max, int tau,
                         int k, const float* __restrict__ dM,
                         const int* __restrict__ iM, int walk_per,
                         int walk_row0, int row_tiles, int nsel,
                         float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) float st_smem[];
  const int tid = threadIdx.x;
  const bool walk = (int)blockIdx.x < N * walk_per;
  const int b = walk ? blockIdx.x : blockIdx.x - N * walk_per;
  const int per = walk ? walk_per : row_tiles;
  const int s = b / per;
  const int unit = b - s * per;
  float* xs = st_smem;
  const float* x = xpad + (size_t)s * Lx;
  for (int q = tid; q < xs_len; q += kStreamThreads)
    xs[q] = q < Lx ? x[q] : 0.f;
  __syncthreads();

  if (walk) {
    const int warp = tid >> 5;
    const int i = walk_row0 + unit * 4 + warp;
    if (i >= L_new) return;
    float* bufv = xs + xs_len + warp * nsel * kBuf;
    int* bufi = reinterpret_cast<int*>(xs + xs_len + 4 * nsel * kBuf) +
                warp * nsel * kBuf;
    walk_row<kSel>(xs, s, i, L_old, L_new, E_max, tau, k, bufv, bufi, out_d,
                   out_i);
    return;
  }

  const int r0 = unit * kStreamThreads;
  const int r1 = min(r0 + kStreamThreads, L_new);
  const int tile = kStreamThreads * k;
  // Level e's tile: roots at xs + xs_len + 2·tile·(e & 1), indices after.
  auto tile_d = [&](int e) { return xs + xs_len + 2 * tile * (e & 1); };
  auto tile_i = [&](int e) {
    return reinterpret_cast<int*>(xs + xs_len + 2 * tile * (e & 1) + tile);
  };
  // Rows [r0, r0 + n_old(e)) of the tile are old at level e.
  auto n_old = [&](int e) { return max(0, min(r1, L_old - e * tau) - r0); };
  auto fetch = [&](int e) {
    const int n = n_old(e) * k;
    if (n > 0) {
      const size_t g = (((size_t)s * E_max + e) * L_old + r0) * k;
      copy_in(tile_d(e), dM + g, n);
      copy_in(tile_i(e), iM + g, n);
    }
    cp_async_commit();
  };
  fetch(0);
  for (int e = 0; e < E_max; ++e) {
    if (e + 1 < E_max) {
      fetch(e + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int nold = n_old(e);
    float* const td = tile_d(e);
    int* const ti = tile_i(e);
    if (tid < nold) {
      const Row r{xs, r0 + tid, e, tau};
      merge_row(r, td + tid * k, ti + tid * k, k, L_old - e * tau,
                L_new - e * tau);
    }
    __syncthreads();
    const size_t o = (((size_t)s * E_max + e) * L_new + r0) * k;
    for (int f = tid; f < nold * k; f += kStreamThreads) {
      out_d[o + f] = td[f];
      out_i[o + f] = ti[f];
    }
    // Rows past the level's last are padding; the new rows between are
    // the walk blocks'.
    const int p0 = max(r0, L_new - e * tau);
    for (int f = (p0 - r0) * k + tid; f < (r1 - r0) * k;
         f += kStreamThreads) {
      out_d[o + f] = INFINITY;
      out_i[o + f] = -1;
    }
    __syncthreads();  // the tile is stored before its buffer is refilled
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

// The stream design: the same tables as knn_append_launch, no block shape
// (kStreamThreads threads a block); k ≤ 32, E_max ≤ 32, and 4·(xs_len +
// max(4·128·k, 8·nsel·kBuf)) bytes of shared memory per block, xs_len =
// Lx + 32 rounded up to 4 and nsel = min(E_max, ⌈dt/τ⌉).
extern "C" int knn_append_stream_launch(const float* xpad, int N, int Lx,
                                        int L_old, int L_new, int E_max,
                                        int tau, int k, const float* dM,
                                        const int* iM, float* out_d,
                                        int* out_i, void* stream) {
  if (N < 1 || E_max < 1 || E_max > 32 || k < 1 || k > 32 ||
      L_new <= L_old || tau < 1)
    return (int)cudaErrorInvalidValue;
  const int dt = L_new - L_old;
  const int xs_len = (Lx + 32 + 3) & ~3;
  const int nsel = E_max < (dt + tau - 1) / tau ? E_max : (dt + tau - 1) / tau;
  // Rows new at some level: [L_old - (E_max-1)·τ, L_new).
  int walk_row0 = L_old - (E_max - 1) * tau;
  walk_row0 = walk_row0 < 0 ? 0 : walk_row0;
  const int tile_words = 4 * kStreamThreads * k;
  const int walk_words = 8 * nsel * kBuf;
  const size_t smem =
      4 * (size_t)(xs_len + (tile_words > walk_words ? tile_words
                                                     : walk_words));
  const int walk_per = (L_new - walk_row0 + 3) / 4;
  const int row_tiles = (L_new + kStreamThreads - 1) / kStreamThreads;
  cudaStream_t st = (cudaStream_t)stream;
  auto go = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)N * (walk_per + row_tiles), kStreamThreads, smem,
             st>>>(xpad, N, Lx, xs_len, L_old, L_new, E_max, tau, k, dM, iM,
                   walk_per, walk_row0, row_tiles, nsel, out_d, out_i);
    return cudaGetLastError();
  };
  return (int)(nsel <= 1    ? go(knn_append_stream_kernel<1>)
               : nsel <= 4  ? go(knn_append_stream_kernel<4>)
               : nsel <= 8  ? go(knn_append_stream_kernel<8>)
               : nsel <= 16 ? go(knn_append_stream_kernel<16>)
               : nsel <= 24 ? go(knn_append_stream_kernel<24>)
                            : go(knn_append_stream_kernel<32>));
}
