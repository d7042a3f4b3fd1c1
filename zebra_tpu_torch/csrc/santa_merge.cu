// SANTA merge of the streaming T-PPR index, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel zebra_tpu/index/pallas_merge.py:_merge_kernel
// (launched by merge_both_pallas) and computes the same function as
// zebra_tpu/index/streaming.py:_merge_both, batched over W edges. Its plain
// PyTorch version is zebra_tpu_torch/index/merge.py:merge_both_reference.
//
// One lane = one update direction of one ensemble member of one edge:
// lane = w*2M + dir*M + member, B = 2*M*W lanes. Lane (w, dir, m) takes
//   s1 = row `dir` of edge w (the row being updated),
//   s2 = row `1-dir` (its partner's row),
// and emits s1's new record for member m:
//   new_norm = norm1*beta + beta
//   scale1   = norm1/new_norm*beta          (decay of s1's own entries)
//   scale2   = beta/new_norm*(1-alpha)      (partner entries merged in)
//   dedup on (eidx, nbr): an s2 entry with an s1 twin folds its weight into
//   the twin; a fresh entry (eidx, partner, ts) with weight scale2*alpha
//   (scale2 when alpha == 0); canonical top-k of the 2k+1 candidates
//   (weight desc, eidx asc, nbr asc); empty slots are zero.
//
// Layout. The kernel reads the gathered packed rows [W, R, F] (R >= 2 rows
// per edge, F = M*(4k+1); member m's fields at m*4k + field*k with fields
// (weight, nbr, eidx, ts), the M norms trailing) and writes the packed new
// rows [W, 2, F] -- exactly what the caller scatters back, so no slicing or
// stacking copies surround the launch.
//
// Design. One warp per lane, four lanes per block. The warp stages the 2k+1
// candidates in shared memory; thread i folds s1 entry i (scanning s2 for its
// twin) and flags s2 entry i as a duplicate (scanning s1); then thread c
// ranks candidate c by counting the candidates that beat it in the canonical
// order, with the candidate index as the last key, so the ranks are a
// permutation and each output slot r < k is written by exactly one
// candidate: its value when live (weight > 0), zero otherwise. Ties exist
// only among dead candidates (live keys are unique after the fold), so the
// result equals the JAX sort and the Pallas argmax rounds. The arithmetic
// uses __fmul_rn/__fadd_rn/__fdiv_rn in the plain version's order and the
// build passes -fmad=false, so nothing contracts into an FMA and the output
// is bit-equal to merge_both_reference on the same inputs.
//
// Bound. At the training wave (W=64, M=2, k=20) one launch moves about
// 0.2 MB (two rows in and two rows out per edge): well under a microsecond
// of HBM time at 3.35 TB/s, and about 3 M compare/multiply operations. The
// kernel is launch-bound on this card. Later work fuses the row gather and
// scatter into it, then runs one launch per superchunk of waves (ROADMAP
// queue 2, stages b and c).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 64;
constexpr int kMaxM = 4;
constexpr int kMaxC = 2 * kMaxK + 1;
constexpr int kWarps = 4;  // lanes per block
constexpr int kPerThread = kMaxK / 32;

struct Coefs {
  float alpha[kMaxM];
  float beta[kMaxM];
};

// Does candidate d come before candidate c in the canonical order?
__device__ __forceinline__ bool beats(float wd, float ed, float nd, int d,
                                      float wc, float ec, float nc, int c) {
  if (wd != wc) return wd > wc;
  if (ed != ec) return ed < ec;
  if (nd != nc) return nd < nc;
  return d < c;
}

__global__ void __launch_bounds__(kWarps * 32)
santa_merge_kernel(const float* __restrict__ rows, long long edge_stride,
                   const int* __restrict__ src, const int* __restrict__ dst,
                   const int* __restrict__ eidx, const float* __restrict__ ts,
                   Coefs coefs, float* __restrict__ out, int n_lanes, int m,
                   int k) {
  __shared__ float sh_w[kWarps][kMaxC];
  __shared__ float sh_n[kWarps][kMaxC];
  __shared__ float sh_e[kWarps][kMaxC];
  __shared__ float sh_t[kWarps][kMaxC];

  const int warp = threadIdx.x >> 5;
  const int tid = threadIdx.x & 31;
  const int lane = blockIdx.x * kWarps + warp;
  if (lane >= n_lanes) return;  // whole warps leave together

  const int member = lane % m;
  const int dir = (lane / m) % 2;
  const int w = lane / (2 * m);
  const int f = m * (4 * k + 1);
  const int c_n = 2 * k + 1;

  const float* edge = rows + (long long)w * edge_stride;
  const float* s1 = edge + dir * f + member * 4 * k;
  const float* s2 = edge + (1 - dir) * f + member * 4 * k;
  const float norm1 = edge[dir * f + 4 * m * k + member];
  const float alpha = coefs.alpha[member];
  const float beta = coefs.beta[member];
  const float new_norm = __fadd_rn(__fmul_rn(norm1, beta), beta);
  const float scale1 = __fmul_rn(__fdiv_rn(norm1, new_norm), beta);
  const float scale2 =
      __fmul_rn(__fdiv_rn(beta, new_norm), __fadd_rn(1.0f, -alpha));

  float* cw = sh_w[warp];
  float* cn = sh_n[warp];
  float* ce = sh_e[warp];
  float* ct = sh_t[warp];

  // stage raw candidates: s1 entries at [0, k), s2 entries at [k, 2k)
  for (int i = tid; i < k; i += 32) {
    cw[i] = s1[i];
    cn[i] = s1[k + i];
    ce[i] = s1[2 * k + i];
    ct[i] = s1[3 * k + i];
    cw[k + i] = s2[i];
    cn[k + i] = s2[k + i];
    ce[k + i] = s2[2 * k + i];
    ct[k + i] = s2[3 * k + i];
  }
  __syncwarp();

  // scale + dedup fold; every thread reads raw weights, so results wait in
  // registers until the whole warp is done reading
  float w1o[kPerThread];
  float w2o[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = tid + 32 * r;
    if (i >= k) break;
    const float w1r = cw[i];
    const float w2r = cw[k + i];
    float fold = 0.0f;
    bool dup = false;
    if (w1r > 0.0f) {
      const float e1 = ce[i], n1 = cn[i];
      for (int j = 0; j < k; ++j) {
        if (cw[k + j] > 0.0f && ce[k + j] == e1 && cn[k + j] == n1) {
          // one twin at most while keys stay unique; a summed fold also
          // matches the plain version when a repeated edge id made two
          fold = __fadd_rn(fold, __fmul_rn(cw[k + j], scale2));
        }
      }
    }
    if (w2r > 0.0f) {
      const float e2 = ce[k + i], n2 = cn[k + i];
      for (int j = 0; j < k; ++j) {
        if (cw[j] > 0.0f && ce[j] == e2 && cn[j] == n2) dup = true;
      }
    }
    w1o[r] = __fadd_rn(__fmul_rn(w1r, scale1), fold);
    w2o[r] = (w2r > 0.0f && !dup) ? __fmul_rn(w2r, scale2) : 0.0f;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = tid + 32 * r;
    if (i >= k) break;
    cw[i] = w1o[r];
    cw[k + i] = w2o[r];
  }
  if (tid == 0) {  // the fresh entry
    cw[2 * k] = alpha != 0.0f ? __fmul_rn(scale2, alpha) : scale2;
    cn[2 * k] = static_cast<float>(dir == 0 ? dst[w] : src[w]);
    ce[2 * k] = static_cast<float>(eidx[w]);
    ct[2 * k] = ts[w];
  }
  __syncwarp();

  // canonical top-k by rank counting
  float* o = out + (long long)(w * 2 + dir) * f + member * 4 * k;
  for (int c = tid; c < c_n; c += 32) {
    const float wc = cw[c], ec = ce[c], nc = cn[c];
    int rank = 0;
    for (int d = 0; d < c_n; ++d) {
      rank += beats(cw[d], ce[d], cn[d], d, wc, ec, nc, c);
    }
    if (rank < k) {
      const bool live = wc > 0.0f;
      o[rank] = live ? wc : 0.0f;
      o[k + rank] = live ? nc : 0.0f;
      o[2 * k + rank] = live ? ec : 0.0f;
      o[3 * k + rank] = live ? ct[c] : 0.0f;
    }
  }
  if (tid == 0) out[(long long)(w * 2 + dir) * f + 4 * m * k + member] = new_norm;
}

}  // namespace

// rows [W, R, F] f32 (edge_stride = elements between edges, rows 0 and 1
// read), src/dst/eidx [W] i32, ts [W] f32, alpha/beta: m floats in HOST
// memory, out [W, 2, F] f32. Launches on `stream`; returns the launch's
// cudaError_t (0 = launched).
extern "C" int santa_merge(const float* rows, long long edge_stride,
                           const int* src, const int* dst, const int* eidx,
                           const float* ts, const float* alpha,
                           const float* beta, float* out, int w, int m, int k,
                           void* stream) {
  if (m < 1 || m > kMaxM || k < 1 || k > kMaxK || w < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (w == 0) return 0;
  Coefs coefs = {};
  for (int i = 0; i < m; ++i) {
    coefs.alpha[i] = alpha[i];
    coefs.beta[i] = beta[i];
  }
  const int n_lanes = 2 * m * w;
  const int blocks = (n_lanes + kWarps - 1) / kWarps;
  santa_merge_kernel<<<blocks, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      rows, edge_stride, src, dst, eidx, ts, coefs, out, n_lanes, m, k);
  return static_cast<int>(cudaGetLastError());
}
