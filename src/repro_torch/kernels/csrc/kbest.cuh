// Warp-cooperative (value, index) k-best lists and the strict distance
// chain. Included by seven kernels: knn_multi_e.cu (its insertion kernel
// for the shapes the buffered selection does not take), knn_batch.cu,
// knn_append.cu, knn_fused.cu and topk.cu (the lists and warp_offer),
// pairwise_dist.cu and smap_gram.cu (add_sq, the strict chain); and by
// warp_select.cuh (before, kEmpty, kFull).
//
// One warp owns one row. Its list is k slots in shared memory, kept
// sorted by (value ascending, index ascending) — the tie order of
// lax.top_k in the JAX reference — so the result does not depend on the
// order in which candidates arrive. The warp offers 32 candidates at a
// time (one column per lane): each lane compares its candidate with the
// list's last slot, a ballot collects the few that beat it, and each of
// those is inserted by the whole warp (warp_offer), so an insertion costs
// a few warp instructions per 32 slots whatever k is, and no lane waits on
// another lane's insertions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace kbest {

// Index of an unfilled slot: loses every (value, index) comparison with
// a real candidate of equal value, including masked (+inf) ones.
constexpr int kEmpty = 0x7fffffff;

// Largest number of embedding levels a launch carries by value.
constexpr int kMaxLevels = 64;

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool before(float v, int j, float w, int i) {
  return v < w || (v == w && j < i);
}

// Fill k slots with empty entries (all lanes of the warp call it).
__device__ __forceinline__ void warp_init(float* d, int* ix, int k) {
  for (int s = threadIdx.x & 31; s < k; s += 32) {
    d[s] = INFINITY;
    ix[s] = kEmpty;
  }
  __syncwarp();
}

// Offer one candidate (v, j) per lane; lanes with live == false offer none.
// All 32 lanes of the warp must call it together.
//
// Each candidate that beats the last slot is inserted by the whole warp in
// one walk down the list, 32 slots at a time from the end: every lane loads
// its slot and its predecessor (a shuffle; lane 0 takes the slot below the
// group), a ballot counts the slots that precede the candidate — a prefix,
// since the list is sorted — and the slots behind the insertion point move
// down by one while the slot at the point takes the candidate. When even
// the slot below the group does not precede it, the group moves down whole
// and the walk goes on below.
__device__ __forceinline__ void warp_offer(float* d, int* ix, int k,
                                           bool live, float v, int j) {
  const int lane = threadIdx.x & 31;
  unsigned pending =
      __ballot_sync(kFull, live && before(v, j, d[k - 1], ix[k - 1]));
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const float cv = __shfl_sync(kFull, v, src);
    const int cj = __shfl_sync(kFull, j, src);
    for (int s0 = ((k - 1) >> 5) << 5;; s0 -= 32) {
      const int s = s0 + lane;
      const bool in = s < k;
      const float sv = in ? d[s] : INFINITY;
      const int sj = in ? ix[s] : kEmpty;
      // The slot below the group (none for the first group).
      const float bv = s0 > 0 ? d[s0 - 1] : -INFINITY;
      const int bj = s0 > 0 ? ix[s0 - 1] : -1;
      float pv = __shfl_up_sync(kFull, sv, 1);
      int pj = __shfl_up_sync(kFull, sj, 1);
      if (lane == 0) {
        pv = bv;
        pj = bj;
      }
      const unsigned ahead = __ballot_sync(kFull, in && before(sv, sj, cv, cj));
      // The insertion point is in this group iff the slot below precedes.
      const bool here = s0 == 0 || before(bv, bj, cv, cj);
      const int p = here ? s0 + __popc(ahead) : s0 - 1;
      __syncwarp();
      if (in && s > p) {
        d[s] = pv;
        ix[s] = pj;
      } else if (in && s == p) {  // p == k: it no longer beats slot k - 1
        d[s] = cv;
        ix[s] = cj;
      }
      __syncwarp();
      if (here) break;
    }
  }
}

// fl(acc + fl((a - b)^2)): each operation rounded on its own, never fused
// into an FMA, so the bits equal the reference's strict chain.
__device__ __forceinline__ float add_sq(float acc, float a, float b) {
  const float d = __fsub_rn(a, b);
  return __fadd_rn(acc, __fmul_rn(d, d));
}

}  // namespace kbest
