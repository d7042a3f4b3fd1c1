// The wave scan of a superchunk of the streaming T-PPR index, all its waves
// in one persistent launch, written by hand for Hopper (sm_90a).
//
// Counterpart of the lax.scan over waves in zebra_tpu/index/waves.py
// (_wave_scan_chunk), whose step merges a wave with the TPU kernel
// zebra_tpu/index/pallas_merge.py:_merge_kernel (merge_both_pallas). Its
// plain PyTorch version is zebra_tpu_torch/index/waves.py:
// wave_scan_reference: per wave a row gather, the merge and a row scatter.
// The merge of one lane is santa_merge.cuh's, shared with santa_merge.cu
// and santa_scan.cu.
//
// The schedule (csrc/wave_schedule.cc) cuts the chunk into waves of
// pairwise node-disjoint events. A later lane of a wave may write a row
// that an earlier lane of the same wave reads as a negative (a write after
// a read may share the wave); no lane reads a row that another lane of its
// wave writes before it. Rows 0-1 of a lane (its src and dst) are written
// by no other lane of the wave.
//
// Grid: G resident blocks of 2M warps, G = min(widest wave, what the
// occupancy of this kernel allows on the card), launched cooperatively so
// that every block runs at once. Block b takes the lanes b, b + G, ... of
// every wave; warp (dir, member) of a lane runs santa::merge_lane for that
// direction and member, as in santa_merge.cu. Per wave:
//   1. each lane's src and dst rows come into shared memory (cp.async);
//      meanwhile its negatives' rows go straight from `data` to ext (they
//      are extraction-only);
//   2. the src and dst rows go to ext; the merge writes the two new rows
//      into the lane's slot of `stage` [widest wave, 2, F];
//   3. grid barrier: every read of the wave precedes every write (skipped
//      for a one-lane wave, whose reads and writes are one block's);
//   4. the lane writes its two new rows from `stage` into `data` (a
//      self-loop writes the same values twice, as the plain scatter does);
//   5. grid barrier: wave w+1 reads what wave w wrote (none after the last
//      wave).
// Before the first wave the blocks write the zero extraction rows of the
// invalid events, which the schedule leaves out.
//
// Memory. `data` is written by the kernel, so it is never read through the
// read-only path (no const __restrict__, no __ldg). The barrier is a
// counter in device memory that the entry point zeroes on the stream before
// the launch: thread 0 of each block fences (release), adds one, spins on
// an acquire load until all G blocks of this barrier have arrived, and
// fences again; block barriers around it carry the order to the block's
// other threads. Barrier i of the launch waits for the count i*G. A spin
// that outlasts 10 s traps, so a fault fails the launch instead of hanging.
//
// Bound. Bytes: each distinct row whose pre-chunk value the chunk reads
// (src, dst and negatives of the scheduled events) read once, each distinct
// row written once, the extraction rows [E, 2+S, F] written once, and the
// columns. At a training superchunk (64,400 events, R = 3, F = 162) that is
// about 145 MB: about 43 us at 3.35 TB/s. The real floor is the chain of
// dependent waves (about 1,000 per superchunk): each costs two grid
// barriers (an atomic round trip to L2 each) and one lane's merge, a
// dependent chain of shuffles. So the kernel is latency-bound at a few
// microseconds per wave; it replaces three launches and a host enqueue per
// wave, and the trailing gather of the extraction rows into stream order.

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

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A barrier that waits this long has lost a block: the kernel traps (the
// launch fails) rather than hang the card.
constexpr unsigned long long kBarrierTimeoutNs = 10'000'000'000ull;

// Every block of the grid arrives before any leaves (file note).
__device__ __forceinline__ void grid_sync(unsigned long long* counter,
                                          unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1ull);
    const unsigned long long t0 = global_ns();
    while (ld_acquire(counter) < target) {
      if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

template <int Q, int P>
__global__ void __launch_bounds__(kMaxThreads)
santa_waves_kernel(float* data, const int* __restrict__ src,
                   const int* __restrict__ dst, const int* __restrict__ neg,
                   const int* __restrict__ eidx, const float* __restrict__ ts,
                   const unsigned char* __restrict__ valid,
                   const int* __restrict__ order,
                   const int* __restrict__ bounds, Coefs coefs,
                   float* __restrict__ ext, float* stage,
                   unsigned long long* counter, long long n_events,
                   int n_waves, int n_neg, int m, int k) {
  __shared__ float in_rows[2][kMaxF];  // [src, dst] of the block's lane

  const int f = m * (4 * k + 1);
  const int r_ext = 2 + n_neg;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int dir = (tid >> 5) / m;
  const int member = (tid >> 5) % m;
  const int g = gridDim.x;
  unsigned long long target = 0;

  for (long long i = blockIdx.x; i < n_events; i += g) {
    if (valid[i] != 0) continue;
    float* e = ext + i * r_ext * f;
    for (int x = tid; x < r_ext * f; x += nt) e[x] = 0.0f;
  }

  for (int w = 0; w < n_waves; ++w) {
    const int lo = bounds[w], hi = bounds[w + 1];
    for (int j = lo + blockIdx.x; j < hi; j += g) {
      const long long e = order[j];
      const int s = src[e], d = dst[e];
      const float* gs = data + (long long)s * f;
      const float* gd = data + (long long)d * f;
      for (int x = tid; x < f; x += nt) {
        cp_async4(&in_rows[0][x], gs + x);
        cp_async4(&in_rows[1][x], gd + x);
      }
      cp_async_commit();
      float* out = ext + e * r_ext * f;
      for (int r = 0; r < n_neg; ++r) {
        const float* gn = data + (long long)neg[e * n_neg + r] * f;
        for (int x = tid; x < f; x += nt) out[(2 + r) * f + x] = gn[x];
      }
      cp_async_wait_all();
      __syncthreads();  // the lane's rows are in
      for (int x = tid; x < f; x += nt) {
        out[x] = in_rows[0][x];
        out[f + x] = in_rows[1][x];
      }
      const float* row1 = in_rows[dir];
      const float* row2 = in_rows[1 - dir];
      float* o = stage + ((long long)(j - lo) * 2 + dir) * f;
      santa::merge_lane<Q, P>(
          row1 + member * 4 * k, row2 + member * 4 * k,
          row1[4 * m * k + member], coefs.alpha[member], coefs.beta[member],
          static_cast<float>(dir == 0 ? d : s), static_cast<float>(eidx[e]),
          ts[e], o + member * 4 * k, o + 4 * m * k + member, k);
      __syncthreads();  // in_rows are free for the block's next lane
    }
    if (hi - lo > 1) {
      grid_sync(counter, target += g);
    }
    for (int j = lo + blockIdx.x; j < hi; j += g) {
      const long long e = order[j];
      float* gs = data + (long long)src[e] * f;
      float* gd = data + (long long)dst[e] * f;
      const float* st = stage + (long long)(j - lo) * 2 * f;
      for (int x = tid; x < f; x += nt) {
        gs[x] = st[x];
        gd[x] = st[f + x];
      }
    }
    if (w + 1 < n_waves) grid_sync(counter, target += g);
  }
}

}  // namespace

// data [N, F] f32, updated in place; src/dst/eidx [E] i32, ts [E] f32,
// valid [E] u8, neg [E, n_neg] i32 (row-major); order [E'] i32, the stream
// positions of the valid events wave after wave, and bounds [n_waves + 1]
// i32 (wave w is order[bounds[w]:bounds[w + 1]], at most `width` lanes);
// alpha/beta: m floats in HOST memory; ext [E, 2 + n_neg, F] f32, written
// in stream order (zero rows for the invalid events); stage [width, 2, F]
// f32 and counter (8 bytes) scratch. Ids must lie in [0, N). Zeroes the
// counter and launches cooperatively on `stream`; writes the grid size to
// *grid_out when it is not null. Returns the first cudaError_t (0 =
// launched).
extern "C" int santa_waves(float* data, const int* src, const int* dst,
                           const int* neg, int n_neg, const int* eidx,
                           const float* ts, const unsigned char* valid,
                           const int* order, const int* bounds, int n_waves,
                           int width, const float* alpha, const float* beta,
                           float* ext, float* stage,
                           unsigned long long* counter, long long n_events,
                           int m, int k, int* grid_out, void* stream) {
  if (m < 1 || m > santa::kMaxM || k < 1 || k > santa::kMaxK ||
      n_events < 0 || n_waves < 0 || width < 0 || n_neg < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_events == 0) return 0;
  Coefs coefs = {};
  for (int i = 0; i < m; ++i) {
    coefs.alpha[i] = alpha[i];
    coefs.beta[i] = beta[i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, coop = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  rc = cudaMemsetAsync(counter, 0, sizeof(unsigned long long), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int threads = 2 * m * 32;
  return santa::dispatch(k, [&](auto q, auto p) {
    auto kernel = santa_waves_kernel<decltype(q)::value, decltype(p)::value>;
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    long long resident = static_cast<long long>(per_sm) * sms;
    const int grid = static_cast<int>(
        width < 1 ? 1 : (width < resident ? width : resident));
    if (grid_out != nullptr) *grid_out = grid;
    void* args[] = {&data,  &src,    &dst,    &neg,      &eidx,
                    &ts,    &valid,  &order,  &bounds,   &coefs,
                    &ext,   &stage,  &counter, &n_events, &n_waves,
                    &n_neg, &m,      &k};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                      dim3(grid), dim3(threads), args, 0, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  });
}
