// The streaming T-PPR scan of a chunk of E events in stream order, one
// launch, written by hand for Hopper (sm_90a).
//
// Counterpart of the lax.scan in zebra_tpu/index/streaming.py
// (streaming_scan, fill_scan), whose step runs the TPU kernel
// zebra_tpu/index/pallas_merge.py:_merge_kernel. Its plain PyTorch version
// is zebra_tpu_torch/index/scan.py:scan_reference: per event a row gather,
// the merge and a masked row scatter. Here gather, merge and scatter stay on
// the device for the whole chunk. The merge of one lane is
// santa_merge.cuh's, shared with santa_merge.cu.
//
// Per event i (src s, dst d, neg n, valid v):
//   1. the pre-edge rows of s and d (and n when extracting) are in shared
//      memory; barrier;
//   2. event i+1's rows are prefetched into the other buffer (cp.async);
//   3. the extraction rows [3, F] go to ext[i], valid or not;
//   4. the merge: warp (dir, member) writes its part of the new row of
//      s (dir 0) or d (dir 1) into shared memory; barrier;
//   5. when v, both new rows are written to data (a self-loop writes the
//      same values twice, as the plain scatter does).
// Forwarding. A row of event i+1 that event i writes (ids equal to s or d,
// v set) is not fetched: event i+1 reads it from event i's new rows in
// shared memory. New rows are double-buffered for that. Any other row of
// event i+1 was last written at an event <= i-1, whose global writes the
// barrier of step 1 orders before the prefetch.
//
// `data` is written by the kernel, so it is never read through the
// read-only path (no const __restrict__, no __ldg); only the event columns
// are.
//
// Why one block. The recurrence is sequential by definition: event i+1
// reads what event i wrote. One block of 2M warps (one per lane) is its
// honest shape. Multi-block waves of node-disjoint events with a grid
// barrier belong to the training wave scheduler, not to this scan.
//
// Shared memory: 2 buffers x 3 input rows + 2 buffers x 2 new rows of at
// most F = 4*(4*64+1) = 1,028 floats: 41,120 bytes, under the 48 KB of
// static shared memory.
//
// Bound. Bytes: each distinct row whose pre-chunk value the chunk needs read
// once (src and dst; neg too when extracting), each distinct row written
// once, the 3 extraction rows per event when asked, and 17 bytes of event
// columns per event (21 with neg). That is at most 2.6 KB per event at M=2,
// k=20 (F=162) without extraction, and less on a stream whose events share
// nodes: under a nanosecond at 3.35 TB/s. The merge's operations take less
// time still. The real floor is the chain of dependent events: each waits
// for its predecessor's merge (a dependent chain of shuffles) and two block
// barriers, so the kernel is latency-bound at microseconds per event.

#include "santa_merge.cuh"

namespace {

using santa::Coefs;

constexpr int kMaxF = santa::kMaxM * (4 * santa::kMaxK + 1);
constexpr int kMaxThreads = 2 * santa::kMaxM * 32;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int Q, int P>
__global__ void __launch_bounds__(kMaxThreads)
santa_scan_kernel(float* data, const int* __restrict__ src,
                  const int* __restrict__ dst, const int* __restrict__ neg,
                  const int* __restrict__ eidx, const float* __restrict__ ts,
                  const unsigned char* __restrict__ valid, Coefs coefs,
                  float* __restrict__ ext, long long n_events, int m, int k) {
  __shared__ float in_rows[2][3][kMaxF];   // [buffer][src, dst, neg]
  __shared__ float new_rows[2][2][kMaxF];  // [buffer][src, dst]

  const int f = m * (4 * k + 1);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int dir = (tid >> 5) / m;
  const int member = (tid >> 5) % m;
  const int n_in = ext != nullptr ? 3 : 2;

  // Fetch event j's rows into in_rows[buf], except those that event j-1
  // (prev_s, prev_d, prev_v) writes: those are forwarded.
  auto prefetch = [&](long long j, int buf, int prev_s, int prev_d,
                      bool prev_v) {
    const int js = src[j], jd = dst[j], jn = n_in == 3 ? neg[j] : 0;
    for (int r = 0; r < n_in; ++r) {
      const int id = r == 0 ? js : (r == 1 ? jd : jn);
      if (prev_v && (id == prev_s || id == prev_d)) continue;
      const float* g = data + (long long)id * f;
      for (int x = tid; x < f; x += nt) cp_async4(&in_rows[buf][r][x], g + x);
    }
    cp_async_commit();
  };

  prefetch(0, 0, 0, 0, false);
  int prev_s = 0, prev_d = 0;
  bool prev_v = false;
  for (long long i = 0; i < n_events; ++i) {
    const int b = static_cast<int>(i & 1);
    const int s = src[i], d = dst[i];
    const bool v = valid[i] != 0;
    cp_async_wait_all();
    __syncthreads();  // event i's rows are in; event i-1's writes are done
    if (i + 1 < n_events) prefetch(i + 1, b ^ 1, s, d, v);

    auto row = [&](int id, int r) -> const float* {
      if (prev_v && id == prev_d) return new_rows[b ^ 1][1];
      if (prev_v && id == prev_s) return new_rows[b ^ 1][0];
      return in_rows[b][r];
    };
    const float* rs = row(s, 0);
    const float* rd = row(d, 1);
    if (ext != nullptr) {
      const float* rn = row(neg[i], 2);
      float* e = ext + i * 3 * f;
      for (int x = tid; x < f; x += nt) {
        e[x] = rs[x];
        e[f + x] = rd[x];
        e[2 * f + x] = rn[x];
      }
    }

    const float* row1 = dir == 0 ? rs : rd;
    const float* row2 = dir == 0 ? rd : rs;
    float* o = new_rows[b][dir];
    santa::merge_lane<Q, P>(
        row1 + member * 4 * k, row2 + member * 4 * k,
        row1[4 * m * k + member], coefs.alpha[member], coefs.beta[member],
        static_cast<float>(dir == 0 ? d : s), static_cast<float>(eidx[i]),
        ts[i], o + member * 4 * k, o + 4 * m * k + member, k);
    __syncthreads();  // both new rows are complete

    if (v) {
      float* gs = data + (long long)s * f;
      float* gd = data + (long long)d * f;
      for (int x = tid; x < f; x += nt) {
        gs[x] = new_rows[b][0][x];
        gd[x] = new_rows[b][1][x];
      }
    }
    prev_s = s;
    prev_d = d;
    prev_v = v;
  }
}

}  // namespace

// data [N, F] f32, updated in place; src/dst/neg/eidx [E] i32, ts [E] f32,
// valid [E] u8; alpha/beta: m floats in HOST memory; ext [E, 3, F] f32 or
// null (no extraction: neg is not read). Ids must lie in [0, N). Launches
// one block on `stream`; returns the launch's cudaError_t (0 = launched).
extern "C" int santa_scan(float* data, const int* src, const int* dst,
                          const int* neg, const int* eidx, const float* ts,
                          const unsigned char* valid, const float* alpha,
                          const float* beta, float* ext, long long n_events,
                          int m, int k, void* stream) {
  if (m < 1 || m > santa::kMaxM || k < 1 || k > santa::kMaxK ||
      n_events < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_events == 0) return 0;
  Coefs coefs = {};
  for (int i = 0; i < m; ++i) {
    coefs.alpha[i] = alpha[i];
    coefs.beta[i] = beta[i];
  }
  return santa::dispatch(k, [&](auto q, auto p) {
    santa_scan_kernel<decltype(q)::value, decltype(p)::value>
        <<<1, 2 * m * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            data, src, dst, neg, eidx, ts, valid, coefs, ext, n_events, m, k);
    return static_cast<int>(cudaGetLastError());
  });
}
