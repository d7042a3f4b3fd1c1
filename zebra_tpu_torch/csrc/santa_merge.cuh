// The SANTA merge of one lane, shared by santa_merge.cu (a wave of W edges)
// and santa_scan.cu (a chunk of events in stream order). Written by hand for
// Hopper (sm_90a); it replaces the body of the TPU kernel
// zebra_tpu/index/pallas_merge.py:_merge_kernel.
//
// One lane = one update direction of one ensemble member of one edge, run
// by one whole warp. It reads s1 (the member's 4k fields of the row being
// updated), s2 (the same fields of the partner row) and the norm of s1, and
// writes s1's new fields and norm:
//   new_norm = norm1*beta + beta
//   scale1   = norm1/new_norm*beta          (decay of s1's own entries)
//   scale2   = beta/new_norm*(1-alpha)      (partner entries merged in)
//   dedup on (eidx, nbr): an s2 entry with an s1 twin folds its weight into
//   the twin; a fresh entry (eidx, partner, ts) with weight scale2*alpha
//   (scale2 when alpha == 0); canonical top-k of the 2k+1 candidates
//   (weight desc, eidx asc, nbr asc, candidate index asc); empty slots zero.
//
// Design, for the warp rather than the TPU's vector unit:
// - Candidates live in registers: s1 entry i and s2 entry i in lane i % 32,
//   register slot i / 32 (Q = ceil(k/32) slots each); the fresh entry takes
//   a spare lane of the last s1 slot, or a slot of its own when k % 32 == 0.
//   P (a power of two) slots of 32 hold all 2k+1 candidates and the padding.
// - Twin lookup: (eidx, nbr) as one 64-bit key, dead entries as sentinels
//   that never match. Lane j's s1 key, s2 key and scaled s2 weight reach
//   every lane by shuffles, one round per entry, and each lane compares
//   them with its own keys: one compare per (entry, slot). The fold sums in
//   entry order, so a repeated edge id folds like the plain version.
// - Selection: a bitonic sort of the 32P candidates across the warp, keys
//   swapped by __shfl_xor_sync (in registers where the partner is in the
//   same lane): log2(32P)(log2(32P)+1)/2 compare steps. It compares (w,
//   eidx, nbr, candidate index): the keys are distinct, so the sort gives
//   the canonical order. Dead slots are written as zeros. The compare and
//   the exchange are selects, not branches: the lanes of a warp disagree on
//   them, and a branch runs both sides in turn (a branching compare made the
//   sort about three times slower on the H100). The Pallas kernel's other
//   selection, k rounds of a warp-wide argmax, measured 1.35-2.1x slower
//   than this sort on the H100 and is not kept.
// - Rounding: __fmul_rn/__fadd_rn/__fdiv_rn in the plain version's order,
//   and the build passes -fmad=false, so the result is bit-equal to
//   zebra_tpu_torch/index/merge.py:merge_both_reference.

#pragma once

#include <cuda_runtime.h>
#include <type_traits>

namespace santa {

constexpr int kMaxK = 64;
constexpr int kMaxM = 4;
constexpr unsigned kFull = 0xffffffffu;
// twin keys of dead entries: never equal to each other or to a live key
// (a live key's high word is the bit pattern of a non-negative id < 2^24)
constexpr unsigned long long kDead1 = ~0ull;
constexpr unsigned long long kDead2 = ~0ull - 1;

struct Coefs {
  float alpha[kMaxM];
  float beta[kMaxM];
};

struct Cand {
  float w, e, n;
  int idx;  // 0..k-1: s1 entry, k..2k-1: s2 entry, 2k: fresh, >= 1024: pad
};

// Does a come before b in the canonical order? Without branches (file
// note).
__device__ __forceinline__ bool beats(const Cand& a, const Cand& b) {
  return (a.w > b.w) |
         ((a.w == b.w) &
          ((a.e < b.e) |
           ((a.e == b.e) & ((a.n < b.n) | ((a.n == b.n) & (a.idx < b.idx))))));
}

__device__ __forceinline__ Cand pick(bool first, const Cand& a,
                                     const Cand& b) {
  return {first ? a.w : b.w, first ? a.e : b.e, first ? a.n : b.n,
          first ? a.idx : b.idx};
}

__device__ __forceinline__ Cand shfl_xor(const Cand& c, int mask) {
  Cand o;
  o.w = __shfl_xor_sync(kFull, c.w, mask);
  o.e = __shfl_xor_sync(kFull, c.e, mask);
  o.n = __shfl_xor_sync(kFull, c.n, mask);
  o.idx = __shfl_xor_sync(kFull, c.idx, mask);
  return o;
}

__device__ __forceinline__ unsigned long long twin_key(float e, float n) {
  return (static_cast<unsigned long long>(__float_as_uint(e)) << 32) |
         __float_as_uint(n);
}

// Bitonic sort, best first: candidate slot p of lane l sits at position
// g = 32p + l.
template <int P>
__device__ __forceinline__ void bitonic_sort(Cand (&c)[P]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * P; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {  // both positions in this lane
        const int ps = stride >> 5;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (p & ps) continue;
          const bool asc = ((p * 32 + lane) & size) == 0;
          const bool swap = beats(c[p | ps], c[p]) == asc;
          const Cand lo = pick(swap, c[p | ps], c[p]);
          c[p | ps] = pick(swap, c[p], c[p | ps]);
          c[p] = lo;
        }
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const Cand o = shfl_xor(c[p], stride);
          const bool asc = ((p * 32 + lane) & size) == 0;
          const bool lower = (lane & stride) == 0;
          // the lower position keeps the better one when ascending
          c[p] = pick(beats(o, c[p]) == (lower == asc), o, c[p]);
        }
      }
    }
  }
}

// One lane of the merge (file note). s1, s2, out: the member's 4k fields
// (weight, nbr, eidx, ts blocks of k); shared or global memory, out apart
// from both inputs. The whole warp calls it.
template <int Q, int P>
__device__ __forceinline__ void merge_lane(const float* s1, const float* s2,
                                           float norm1, float alpha,
                                           float beta, float fresh_n,
                                           float fresh_e, float fresh_t,
                                           float* out, float* out_norm,
                                           int k) {
  const int lane = threadIdx.x & 31;
  const float new_norm = __fadd_rn(__fmul_rn(norm1, beta), beta);
  const float scale1 = __fmul_rn(__fdiv_rn(norm1, new_norm), beta);
  const float scale2 =
      __fmul_rn(__fdiv_rn(beta, new_norm), __fadd_rn(1.0f, -alpha));

  float w1[Q], e1[Q], n1[Q], w2[Q], e2[Q], n2[Q], w2s[Q], fold[Q];
  unsigned long long key1[Q], key2[Q];
  bool dup[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = 32 * q + lane;
    const bool in = i < k;
    w1[q] = in ? s1[i] : 0.0f;
    n1[q] = in ? s1[k + i] : 0.0f;
    e1[q] = in ? s1[2 * k + i] : 0.0f;
    w2[q] = in ? s2[i] : 0.0f;
    n2[q] = in ? s2[k + i] : 0.0f;
    e2[q] = in ? s2[2 * k + i] : 0.0f;
    key1[q] = w1[q] > 0.0f ? twin_key(e1[q], n1[q]) : kDead1;
    key2[q] = w2[q] > 0.0f ? twin_key(e2[q], n2[q]) : kDead2;
    w2s[q] = __fmul_rn(w2[q], scale2);
    fold[q] = 0.0f;
    dup[q] = false;
  }

  // twin lookup: entry j's keys reach every lane in turn (unrolled, so
  // that the shuffles of neighbouring entries overlap)
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int entries = min(32, k - 32 * q);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j == entries) break;
      const unsigned long long k1 = __shfl_sync(kFull, key1[q], j);
      const unsigned long long k2 = __shfl_sync(kFull, key2[q], j);
      const float ws = __shfl_sync(kFull, w2s[q], j);
#pragma unroll
      for (int r = 0; r < Q; ++r) {
        if (key1[r] == k2) fold[r] = __fadd_rn(fold[r], ws);
        dup[r] = dup[r] || key2[r] == k1;
      }
    }
  }

  const Cand pad = {-1.0f, 0.0f, 0.0f, 0};
  Cand c[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    c[p] = pad;
    c[p].idx = 1024 + 32 * p + lane;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = 32 * q + lane;
    if (i < k) {
      c[q] = {__fadd_rn(__fmul_rn(w1[q], scale1), fold[q]), e1[q], n1[q], i};
      c[Q + q] = {(w2[q] > 0.0f && !dup[q]) ? w2s[q] : 0.0f, e2[q], n2[q],
                  k + i};
    }
  }
  const Cand fresh = {alpha != 0.0f ? __fmul_rn(scale2, alpha) : scale2,
                      fresh_e, fresh_n, 2 * k};
  if constexpr (P > 2 * Q) {  // k % 32 == 0: a slot of its own
    if (lane == 0) c[2 * Q] = fresh;
  } else if (lane == (k & 31)) {
    c[Q - 1] = fresh;
  }

  bitonic_sort<P>(c);

#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int g = 32 * q + lane;
    if (g < k) {
      const Cand& x = c[q];
      const bool live = x.w > 0.0f;
      float t = 0.0f;
      if (live) {
        t = x.idx < k ? s1[3 * k + x.idx]
                      : (x.idx < 2 * k ? s2[2 * k + x.idx] : fresh_t);
      }
      out[g] = live ? x.w : 0.0f;
      out[k + g] = live ? x.n : 0.0f;
      out[2 * k + g] = live ? x.e : 0.0f;
      out[3 * k + g] = t;
    }
  }
  if (lane == 0) *out_norm = new_norm;
}

// Calls f(Q, P) with compile-time values for this k (1 <= k <= 64):
// Q = ceil(k/32) register slots per entry row; P slots of candidates.
template <class F>
int dispatch(int k, F&& f) {
  using std::integral_constant;
  if (k < 32) return f(integral_constant<int, 1>{}, integral_constant<int, 2>{});
  if (k == 32) return f(integral_constant<int, 1>{}, integral_constant<int, 4>{});
  if (k < 64) return f(integral_constant<int, 2>{}, integral_constant<int, 4>{});
  return f(integral_constant<int, 2>{}, integral_constant<int, 8>{});
}

}  // namespace santa
