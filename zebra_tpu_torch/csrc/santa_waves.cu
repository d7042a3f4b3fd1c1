// The wave scan of a superchunk of the streaming T-PPR index, all its waves
// in one launch of one thread-block cluster, written by hand for Hopper
// (sm_90a).
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
// pairwise node-disjoint events: the src and dst rows of a wave's lanes are
// distinct, and no lane reads a row that an earlier lane of its wave
// writes. A lane may read as a negative a row that a later lane of its wave
// (or the lane itself) writes: the plan's redirect list names every such
// (reader, negative slot, writer, src or dst row), and the writer, which
// holds that row's pre-wave value in shared memory, writes it into the
// reader's extraction row, which the reader skips. So no lane of a wave
// reads from `data` a row that another lane of the wave writes, and the
// merge writes the new rows straight into `data`.
//
// Launch: one cluster of C blocks (C <= 16, non-portable above 8; one block
// per SM, co-scheduled by the hardware), L lanes per block, a lane being
// 2M warps (warp (dir, member) runs santa::merge_lane for that direction
// and member, as in santa_merge.cu). Lane i of a wave goes to block
// i % C, slot (i / C) % L, in pass i / (C·L): a wave wider than the
// cluster's C·L lanes takes several passes. C, L and the shared memory are
// computed by the binding (index/wave_kernel.py:geometry).
//
// Prologue: the blocks write the zero extraction rows of the invalid
// events (the schedule leaves them out) and each scheduled lane's record
// into `records` [E', 8 + S] i32 (event, src, dst, eidx, ts, its redirect
// rows, its negatives' ids with -1 for a redirected one: all read-only
// columns), then one cluster barrier. Per pass of a wave, each lane, its
// record in shared memory:
//   1. brings its src and dst rows into shared memory (cp.async, one
//      group), and in a second group the rows of its negatives that are
//      not redirected and the record of the slot's next lane (so no
//      metadata load waits on L2 after the barrier);
//   2. once the first group is in: writes the two rows to its extraction
//      rows, writes the redirected rows it owes, and merges, the new rows
//      going straight into `data` (a self-loop's two directions write the
//      same values, as the plain scatter does);
//   3. waits for the second group (the next wave may write the
//      negatives' rows) and, at the wave's last pass, arrives at the
//      cluster barrier (barrier.cluster.arrive.release);
//   4. stores its negatives' rows to its extraction rows while the other
//      blocks arrive, then waits (barrier.cluster.wait.acquire): wave w+1
//      reads what wave w wrote.
//
// Memory. `data` is written by the kernel, so it is never read through the
// read-only path (no const __restrict__, no __ldg). Rows another block
// wrote are read by cp.async after the cluster barrier's wait.acquire,
// which sm_90a compiles to the barrier wait and an L1 invalidation
// (CCTL.IVALL); the arrive.release is a MEMBAR.ALL.GPU and the barrier
// arrive. Rows are F = M(4k+1) floats, 648 B at (M, k) = (2, 20): not a
// multiple of 16 and only 4- or 8-byte aligned, so the copies are 4-byte
// cp.async (16-byte cp.async and TMA would need a padded row stride).
//
// Bound. Bytes: each distinct row whose pre-chunk value the chunk reads
// (src, dst and negatives of the scheduled events) read once, each
// distinct row written once, the extraction rows [E, 2+S, F] written once,
// and the columns. At a training superchunk (64,400 events, R = 3, F =
// 162) that is 0.048 ms at 3.35 TB/s. The real floor is the chain of
// dependent waves: 1,007 at the bench superchunk's cap of 64 lanes, 730
// with no cap (the data's own depth). A wave costs one L2 load of the
// lanes' rows, their merges and one cluster barrier. The merges are the
// largest part: a cluster holds at most 16 SMs, so a 64-lane wave puts 16
// merging warps on each SM, and santa::merge_lane's shuffles and selects
// then keep its four schedulers issuing (about 3 µs a wave, where one lane
// per SM is the chain's latency, about 2 µs). The design keeps the rest
// small: one barrier per wave, the new rows straight into `data`, the
// negatives and the next lane's record copied while the merge runs.
//
// Trace. With a non-null `trace` [n_waves, 4] i64 the Trace instantiation
// runs: thread 0 of block 0 writes clock64() when its lane's rows are in
// (the wave's first pass), when its merge is done and the second group in,
// when it has arrived and stored its negatives (both at the wave's last
// pass), and when the wait is over.

#include "santa_merge.cuh"
#include "santa_sync.cuh"

namespace {

using santa::Coefs;
using santa::cluster_arrive;
using santa::cluster_wait;
using santa::cp_async4;
using santa::cp_async_commit;
using santa::cp_async_wait_all;
using santa::cp_async_wait_older;
using santa::lane_sync;

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;  // 227 KB a block may use

// A lane's metadata record (i32): the fields, then its negatives' ids, -1
// for a redirected one.
enum Meta { kEvent, kSrc, kDst, kEidx, kTs, kRedLo, kRedHi, kNeg = 8 };

template <int Q, int P, bool Trace>
__global__ void __launch_bounds__(kMaxThreads, 1)
santa_waves_kernel(float* data, const int* __restrict__ src,
                   const int* __restrict__ dst, const int* __restrict__ neg,
                   const int* __restrict__ eidx, const float* __restrict__ ts,
                   const unsigned char* __restrict__ valid,
                   const int* __restrict__ order,
                   const int* __restrict__ bounds,
                   const int* __restrict__ red_start,
                   const int* __restrict__ redirect,
                   const unsigned char* __restrict__ red_mask, Coefs coefs,
                   float* __restrict__ ext, int* __restrict__ records,
                   long long n_events, int n_waves, int n_neg, int m, int k,
                   int lanes, long long* __restrict__ trace) {
  extern __shared__ float smem[];

  const int f = m * (4 * k + 1);
  const int r_ext = 2 + n_neg;
  const int rec = kNeg + n_neg;
  const int tid = threadIdx.x;
  const int lane_threads = 64 * m;
  const int l = tid / lane_threads;  // lane slot of the block
  const int lt = tid % lane_threads;
  const int dir = (lt >> 5) / m;
  const int member = (lt >> 5) % m;
  const int c = gridDim.x;  // the grid is the cluster
  const int per_pass = c * lanes;
  const int slot = l * c + blockIdx.x;
  float* rows = smem + (long long)l * r_ext * f;  // src, dst, negatives
  int* metas =  // two records per lane slot, for alternate passes
      reinterpret_cast<int*>(smem + (long long)lanes * r_ext * f) +
      2 * l * rec;
  const bool stamps = Trace && blockIdx.x == 0 && tid == 0;
  const int n_sched = n_waves > 0 ? bounds[n_waves] : 0;

  // Prologue: the invalid events' zero extraction rows (a warp per 32
  // events: one coalesced read of `valid`, then the warp writes each
  // invalid event's rows), and every scheduled lane's record in wave order
  // (read-only columns, so the passes can copy the next lane's record while
  // they merge).
  const long long n_warps = (long long)c * (blockDim.x >> 5);
  for (long long base = ((long long)blockIdx.x * (blockDim.x >> 5) +
                         (tid >> 5)) * 32;
       base < n_events; base += 32 * n_warps) {
    const long long i = base + (tid & 31);
    unsigned zero = __ballot_sync(santa::kFull, i < n_events && !valid[i]);
    for (; zero != 0; zero &= zero - 1) {
      float* e = ext + (base + __ffs(zero) - 1) * r_ext * f;
      for (int x = tid & 31; x < r_ext * f; x += 32) e[x] = 0.0f;
    }
  }
  for (int p = blockIdx.x * blockDim.x + tid; p < n_sched;
       p += c * blockDim.x) {
    const int e = order[p];
    int* r = records + (long long)p * rec;
    r[kEvent] = e;
    r[kSrc] = src[e];
    r[kDst] = dst[e];
    r[kEidx] = eidx[e];
    r[kTs] = __float_as_int(ts[e]);
    r[kRedLo] = red_start[p];
    r[kRedHi] = red_start[p + 1];
    r[kNeg - 1] = 0;
    for (int q = 0; q < n_neg; ++q) {
      r[kNeg + q] = red_mask[(long long)p * n_neg + q]
                        ? -1
                        : neg[(long long)e * n_neg + q];
    }
  }
  if (n_waves == 0) return;
  cluster_arrive();
  cluster_wait();

  // lane j's record into record buffer b (in the group being built)
  auto fetch = [&](int j, int b) {
    const int* from = records + (long long)j * rec;
    for (int x = lt; x < rec; x += lane_threads) {
      cp_async4(reinterpret_cast<float*>(metas + b * rec + x),
                reinterpret_cast<const float*>(from + x));
    }
  };
  int lo = bounds[0], hi = bounds[1];
  int b = 0;  // the record buffer of this pass
  if (slot < hi - lo) fetch(lo + slot, b);
  cp_async_commit();
  cp_async_wait_all();
  lane_sync(l, lane_threads);
  for (int w = 0; w < n_waves; ++w) {
    const int hi_next = w + 1 < n_waves ? bounds[w + 2] : hi;
    for (int base = lo;; base += per_pass, b ^= 1) {  // one pass or more
      const int j = base + slot;
      const bool mine = j < hi;  // the lane's warps agree
      const bool last = base + per_pass >= hi;
      // the slot's lane of the next pass: this wave's or the next one's
      const int jn = last ? (w + 1 < n_waves ? hi + slot : hi_next)
                          : base + per_pass + slot;
      const int* meta = metas + b * rec;
      float* out = nullptr;
      if (mine) {
        const int s = meta[kSrc], d = meta[kDst];
        const float* gs = data + (long long)s * f;
        const float* gd = data + (long long)d * f;
        for (int x = lt; x < f; x += lane_threads) {
          cp_async4(&rows[x], gs + x);
          cp_async4(&rows[f + x], gd + x);
        }
        cp_async_commit();
        for (int r = 0; r < n_neg; ++r) {
          const int g = meta[kNeg + r];
          if (g < 0) continue;
          for (int x = lt; x < f; x += lane_threads) {
            cp_async4(&rows[(2 + r) * f + x], data + (long long)g * f + x);
          }
        }
      }
      if (jn < (last ? hi_next : hi)) fetch(jn, b ^ 1);
      cp_async_commit();
      if (mine) {
        const int s = meta[kSrc], d = meta[kDst];
        cp_async_wait_older();
        lane_sync(l, lane_threads);  // the src and dst rows are in
        if (stamps && base == lo) trace[(long long)w * 4] = clock64();

        out = ext + (long long)meta[kEvent] * r_ext * f;
        for (int x = lt; x < f; x += lane_threads) {
          out[x] = rows[x];
          out[f + x] = rows[f + x];
        }
        for (int q = meta[kRedLo]; q < meta[kRedHi]; ++q) {
          const int* rd = redirect + 4 * (long long)q;
          const float* from = rows + rd[3] * f;  // the src or dst row
          float* to = ext + ((long long)rd[1] * r_ext + 2 + rd[2]) * f;
          for (int x = lt; x < f; x += lane_threads) to[x] = from[x];
        }
        const float* row1 = rows + dir * f;
        const float* row2 = rows + (1 - dir) * f;
        float* o = data + (long long)(dir == 0 ? s : d) * f;
        santa::merge_lane<Q, P>(
            row1 + member * 4 * k, row2 + member * 4 * k,
            row1[4 * m * k + member], coefs.alpha[member],
            coefs.beta[member], static_cast<float>(dir == 0 ? d : s),
            static_cast<float>(meta[kEidx]), __int_as_float(meta[kTs]),
            o + member * 4 * k, o + 4 * m * k + member, k);
      }
      cp_async_wait_all();
      lane_sync(l, lane_threads);  // merged; negatives and next record in
      if (stamps) trace[(long long)w * 4 + 1] = clock64();
      // the wave's last pass arrives as soon as its writes are out and
      // stores its negatives' rows while the other blocks arrive
      if (last && w + 1 < n_waves) cluster_arrive();
      if (mine) {
        for (int r = 0; r < n_neg; ++r) {
          if (meta[kNeg + r] < 0) continue;
          for (int x = lt; x < f; x += lane_threads) {
            out[(2 + r) * f + x] = rows[(2 + r) * f + x];
          }
        }
      }
      lane_sync(l, lane_threads);  // `rows` and this record are free
      if (!last) continue;
      if (stamps) trace[(long long)w * 4 + 2] = clock64();
      if (w + 1 < n_waves) cluster_wait();
      if (stamps) trace[(long long)w * 4 + 3] = clock64();
      b ^= 1;
      break;
    }
    lo = hi;
    hi = hi_next;
  }
}

}  // namespace

// data [N, F] f32, updated in place; src/dst/eidx [E] i32, ts [E] f32,
// valid [E] u8, neg [E, n_neg] i32 (row-major); order [E'] i32, the stream
// positions of the valid events wave after wave, and bounds [n_waves + 1]
// i32 (wave w is order[bounds[w]:bounds[w + 1]]); the redirect list:
// redirect [n, 4] i32 rows (writer's place in order, reader's stream
// position, negative slot, 0 for the writer's src row or 1 for its dst
// row) sorted by writer, red_start [E' + 1] i32 (the writer at order[j]
// owns rows red_start[j]:red_start[j + 1]) and red_mask [E', n_neg] u8
// (1 where the reader at order[j] skips that negative); alpha/beta: m
// floats in HOST memory; ext [E, 2 + n_neg, F] f32, written in stream
// order (zero rows for the invalid events); records [E', 8 + n_neg] i32
// scratch. The geometry: `cluster` blocks of `lanes` lanes and
// `smem_bytes` = lanes·((2 + n_neg)·F + 2·(8 + n_neg))·4 bytes of shared
// memory (each lane's rows and two records). trace: null, or [n_waves, 4]
// i64 for the traced instantiation. Ids must lie in [0, N). Launches on
// `stream`; returns the first cudaError_t (0 = launched).
extern "C" int santa_waves(float* data, const int* src, const int* dst,
                           const int* neg, int n_neg, const int* eidx,
                           const float* ts, const unsigned char* valid,
                           const int* order, const int* bounds, int n_waves,
                           const int* red_start, const int* redirect,
                           const unsigned char* red_mask, const float* alpha,
                           const float* beta, float* ext, int* records,
                           long long n_events, int m, int k, int cluster,
                           int lanes, int smem_bytes, long long* trace,
                           void* stream) {
  const long long f = m * (4LL * k + 1);
  if (m < 1 || m > santa::kMaxM || k < 1 || k > santa::kMaxK ||
      n_events < 0 || n_waves < 0 || n_neg < 1 || cluster < 1 ||
      cluster > kMaxCluster || lanes < 1 || lanes * 64 * m > kMaxThreads ||
      smem_bytes > kMaxSmem ||
      smem_bytes != lanes * ((2 + n_neg) * f + 2 * (kNeg + n_neg)) * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_events == 0) return 0;
  Coefs coefs = {};
  for (int i = 0; i < m; ++i) {
    coefs.alpha[i] = alpha[i];
    coefs.beta[i] = beta[i];
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(lanes * 64 * m);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return santa::dispatch(k, [&](auto q, auto p) {
    constexpr int kQ = decltype(q)::value, kP = decltype(p)::value;
    auto kernel = trace != nullptr ? santa_waves_kernel<kQ, kP, true>
                                   : santa_waves_kernel<kQ, kP, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    }
    int clusters = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    err = cudaLaunchKernelEx(&cfg, kernel, data, src, dst, neg, eidx, ts,
                             valid, order, bounds, red_start, redirect,
                             red_mask, coefs, ext, records, n_events,
                             n_waves, n_neg, m, k, lanes, trace);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  });
}
