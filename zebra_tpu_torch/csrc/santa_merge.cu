// SANTA merge of a wave of W edges of the streaming T-PPR index, written by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel zebra_tpu/index/pallas_merge.py:_merge_kernel
// (launched by merge_both_pallas) and computes the same function as
// zebra_tpu/index/streaming.py:_merge_both, batched over W edges. Its plain
// PyTorch version is zebra_tpu_torch/index/merge.py:merge_both_reference.
// The merge of one lane is santa_merge.cuh's, shared with santa_scan.cu.
//
// Lanes: lane = w*2M + dir*M + member, B = 2*M*W lanes. Lane (w, dir, m)
// takes s1 = row `dir` of edge w (the row being updated) and s2 = row
// `1-dir` (its partner's row), and emits s1's new record for member m.
//
// Layout. The kernel reads the gathered packed rows [W, R, F] (R >= 2 rows
// per edge, F = M*(4k+1); member m's fields at m*4k + field*k with fields
// (weight, nbr, eidx, ts), the M norms trailing) and writes the packed new
// rows [W, 2, F] -- exactly what the caller scatters back.
//
// Bound. At the training wave (W=64, M=2, k=20) one launch moves about
// 0.17 MB (two rows in and two rows out per edge): well under a microsecond
// of HBM time at 3.35 TB/s. One warp per lane and four lanes per block; the
// kernel is bound by launch latency and the merge body's dependent shuffle
// chain. The gather and scatter around it stay in the caller (edge_step);
// the serving scan fuses them (santa_scan.cu).

#include "santa_merge.cuh"

namespace {

using santa::Coefs;

constexpr int kWarps = 4;  // lanes per block

template <int Q, int P>
__global__ void __launch_bounds__(kWarps * 32)
santa_merge_kernel(const float* __restrict__ rows, long long edge_stride,
                   const int* __restrict__ src, const int* __restrict__ dst,
                   const int* __restrict__ eidx, const float* __restrict__ ts,
                   Coefs coefs, float* __restrict__ out, int n_lanes, int m,
                   int k) {
  const int lane = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (lane >= n_lanes) return;  // whole warps leave together

  const int member = lane % m;
  const int dir = (lane / m) % 2;
  const int w = lane / (2 * m);
  const int f = m * (4 * k + 1);
  const float* edge = rows + (long long)w * edge_stride;
  const float* row1 = edge + dir * f;
  const float* row2 = edge + (1 - dir) * f;
  float* o = out + (long long)(w * 2 + dir) * f;
  santa::merge_lane<Q, P>(
      row1 + member * 4 * k, row2 + member * 4 * k, row1[4 * m * k + member],
      coefs.alpha[member], coefs.beta[member],
      static_cast<float>(dir == 0 ? dst[w] : src[w]),
      static_cast<float>(eidx[w]), ts[w], o + member * 4 * k,
      o + 4 * m * k + member, k);
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
  if (m < 1 || m > santa::kMaxM || k < 1 || k > santa::kMaxK || w < 0) {
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
  return santa::dispatch(k, [&](auto q, auto p) {
    santa_merge_kernel<decltype(q)::value, decltype(p)::value>
        <<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            rows, edge_stride, src, dst, eidx, ts, coefs, out, n_lanes, m, k);
    return static_cast<int>(cudaGetLastError());
  });
}
