// The streaming T-PPR scan of a chunk of E events in stream order, one
// launch of one thread-block cluster, written by hand for Hopper (sm_90a).
//
// Counterpart of the lax.scan in zebra_tpu/index/streaming.py
// (streaming_scan, fill_scan), whose step runs the TPU kernel
// zebra_tpu/index/pallas_merge.py:_merge_kernel. Its plain PyTorch version
// is zebra_tpu_torch/index/scan.py:scan_reference: per event a row gather,
// the merge and a masked row scatter. The merge of one lane is
// santa_merge.cuh's, shared with santa_merge.cu and santa_waves.cu.
//
// Per event i (src s, dst d, neg n, valid v) the scan reads the pre-edge
// rows of s and d (and n when extracting), writes them to ext[i] when
// extracting (valid or not), and, when v, writes the merged rows of s and
// d (a self-loop writes one row, the same values twice). Without
// extraction an invalid event does nothing and neg is never read.
//
// Levels. The recurrence is sequential only between events that share a
// row: event j runs after every earlier event that writes a row j reads
// or writes (read after write) and, when j writes, after every earlier
// event that reads a row j writes (write after read, a negative's read
// included). An event's level is one more than the largest level of those
// events, so the events of a level share no row that one of them writes,
// and running the levels in order, the events of a level at once, reads
// every row as the stream order would (a row's writers have increasing
// levels, and a later writer's level is above every read before it). On
// the bench stream a 200-event chunk has 3-7 levels.
//
// Prologue, per tile of at most `tile` events (the binding's geometry),
// computed by every block on its own so that none waits on another:
//   1. the tile's columns into shared memory;
//   2. each touched row a slot of a hash table in shared memory (atomicCAS,
//      linear probing, at most three quarters full);
//   3. the levels, peeled in rounds: in round r every event not yet placed
//      puts its key (r, event) into its rows' slots with atomicMin, the
//      touches into one table and the writes into another; an event whose
//      rows hold no earlier event's write key, and, when it writes, no
//      earlier event's touch key, depends on no event left: it is level r.
//      A key holds 0xffff - r in its high half, so a later round's keys
//      undercut an earlier round's and the tables need no reset. Thread t
//      owns a run of consecutive events, and a block prefix sum of the
//      runs' counts appends level r to the lists in stream order: every
//      block builds the same lists, so that event q of a level is the same
//      event on every block. A round costs four block barriers.
// The plan stays on the device: no host plan and no host read.
//
// Executor: one cluster of C blocks (C <= 16, non-portable above 8; one
// block per SM), L lanes per block, a lane being 2M warps (warp (dir,
// member) runs santa::merge_lane for that direction and member). Event q
// of a level goes to block q % C, slot (q / C) % L, in pass q / (C·L): a
// level wider than the cluster's C·L lanes takes several passes. Per pass
// each lane brings in its rows with cp.async (a row is 4-byte aligned),
// writes them to ext, merges, and writes the new rows straight into
// `data` (no other lane of the level reads or writes them). After the
// level's last pass every thread arrives at the cluster barrier and waits;
// a tile's last level runs the next tile's prologue between the arrive and
// the wait.
//
// Memory. `data` is written by the kernel, so it is never read through the
// read-only path; the event columns are. Rows another block wrote are read
// after the barrier's wait.acquire (santa_sync.cuh).
//
// Bound. Bytes: each distinct row whose pre-chunk value the chunk needs read
// once (src and dst; neg too when extracting), each distinct row written
// once, the 3 extraction rows per event when asked, and 17 bytes of event
// columns per event (21 with neg): under a microsecond at 3.35 TB/s for a
// 200-event chunk at (M, k) = (2, 20). The real floor is the chain of
// levels: per level one L2 load of the rows, one merge chain (a dependent
// chain of shuffles, microseconds) and one cluster barrier.
//
// Trace. With a non-null `trace` [E + 1, 5] i64 (zeroed by the caller) the
// Trace instantiation runs: thread 0 of block 0 writes clock64() at the
// kernel's start (row 0, column 0) and, for the level of global index v
// (row 1 + v), at its tile's prologue end (column 0, the tile's first level
// only), when its lane's rows are in (first pass), when its merge is done
// (each pass), when it has arrived and when the wait is over (the chunk's
// last level, which has no barrier, stamps both at its merge's end). At the
// end row 0 gets the depth (column 1) and the tiles (column 2); columns 3
// and 4 split the first tile's plan: the slots are in, the levels are
// peeled.

#include "santa_merge.cuh"
#include "santa_sync.cuh"

namespace {

using santa::Coefs;
using santa::cluster_arrive;
using santa::cluster_wait;
using santa::cp_async4;
using santa::cp_async_commit;
using santa::cp_async_wait_all;
using santa::lane_sync;

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;  // 227 KB a block may use
constexpr int kMaxTile = 2000;    // 6,000 touches fill 8,192 slots 3/4 full
constexpr int kMaxHash = 8192;
constexpr int kRows = 3;          // a lane's rows: src, dst, neg
constexpr unsigned kLow = 0xffffu;
constexpr int kUnplaced = -2, kReady = -3;  // t_level while peeling

// Bytes of shared memory: per lane kRows rows; the plan's hash keys and
// touch and write keys [hash], columns src, dst, neg, level, order [tile],
// level bounds [tile + 1], touch slots i16 [3 * tile], valid u8 [tile].
constexpr long long smem_size(int lanes, int f, int tile, int hash) {
  return 4LL * ((long long)lanes * kRows * f + 3LL * hash + 5LL * tile +
                tile + 1) +
         2LL * 3 * tile + tile;
}

// The exclusive prefix sum of x over the block's threads in thread order;
// `total` gets the block's sum. Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_sum(int x, int& total) {
  __shared__ int warp_sums[33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto warp_inclusive = [lane](int v) {
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(santa::kFull, v, o);
      if (lane >= o) v += y;
    }
    return v;
  };
  const int incl = warp_inclusive(x);
  __syncthreads();  // a previous call's sums are read
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane]
                                                           : 0;
    const int wi = warp_inclusive(w);
    warp_sums[lane] = wi - w;
    if (lane == 31) warp_sums[32] = wi;
  }
  __syncthreads();
  total = warp_sums[32];
  return warp_sums[warp] + incl - x;
}

// events of the tile that starts at event lo
__device__ __forceinline__ int tile_events(long long lo, long long n_events,
                                           int tile) {
  return static_cast<int>(n_events - lo < tile ? n_events - lo : tile);
}

template <int Q, int P, bool Trace>
__global__ void __launch_bounds__(kMaxThreads, 1)
santa_scan_kernel(float* data, const int* __restrict__ src,
                  const int* __restrict__ dst, const int* __restrict__ neg,
                  const int* __restrict__ eidx, const float* __restrict__ ts,
                  const unsigned char* __restrict__ valid, Coefs coefs,
                  float* __restrict__ ext, long long n_events, int m, int k,
                  int lanes, int tile, int hash, int* __restrict__ levels,
                  long long* __restrict__ trace) {
  extern __shared__ float smem[];

  const int f = m * (4 * k + 1);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane_threads = 64 * m;
  const int l = tid / lane_threads;  // lane slot of the block
  const int lt = tid % lane_threads;
  const int dir = (lt >> 5) / m;
  const int member = (lt >> 5) % m;
  const int c = gridDim.x;  // the grid is the cluster
  const int per_pass = c * lanes;
  const int slot = l * c + blockIdx.x;
  const bool extract = ext != nullptr;
  const bool stamps = Trace && blockIdx.x == 0 && tid == 0;
  const int hash_bits = __ffs(hash) - 1;

  float* rows = smem + (long long)l * kRows * f;  // src, dst, neg
  int* keys = reinterpret_cast<int*>(smem + (long long)lanes * kRows * f);
  unsigned* touch_key = reinterpret_cast<unsigned*>(keys + hash);
  unsigned* write_key = touch_key + hash;
  int* t_src = reinterpret_cast<int*>(write_key + hash);
  int* t_dst = t_src + tile;
  int* t_neg = t_dst + tile;
  int* t_level = t_neg + tile;
  int* order = t_level + tile;
  int* bounds = order + tile;  // [tile + 1]
  short* slots = reinterpret_cast<short*>(bounds + tile + 1);
  unsigned char* t_valid = reinterpret_cast<unsigned char*>(slots + 3 * tile);

  if (stamps) trace[0] = clock64();

  // The plan of the tile of events [lo, lo + te), its levels numbered from
  // `base`: level v's events in order[bounds[v]:bounds[v + 1]], in stream
  // order; returns the depth.
  auto plan = [&](long long lo, int te, int base) {
    __syncthreads();  // the previous tile's plan is no longer read
    for (int x = tid; x < hash; x += nt) {
      keys[x] = -1;
      touch_key[x] = write_key[x] = ~0u;
    }
    for (int e = tid; e < te; e += nt) {
      t_src[e] = src[lo + e];
      t_dst[e] = dst[lo + e];
      t_neg[e] = extract ? neg[lo + e] : -1;
      t_valid[e] = valid[lo + e];
    }
    __syncthreads();
    // each touch's slot, -1 for none: neg only when extracting, nothing for
    // an invalid event without extraction
    for (int x = tid; x < 3 * te; x += nt) {
      const int e = x / 3, r = x - 3 * e;
      const bool on = r < 2 ? (extract || t_valid[e] != 0) : extract;
      int h = -1;
      if (on) {
        const int id = r == 0 ? t_src[e] : (r == 1 ? t_dst[e] : t_neg[e]);
        h = static_cast<int>((static_cast<unsigned>(id) * 0x9E3779B1u) >>
                             (32 - hash_bits));
        for (;;) {
          const int old = atomicCAS(&keys[h], -1, id);
          if (old == -1 || old == id) break;
          h = (h + 1) & (hash - 1);
        }
      }
      slots[x] = static_cast<short>(h);
    }
    // this thread's run of consecutive events; the events to place
    const int run = (te + nt - 1) / nt;
    const int e0 = min(tid * run, te), e1 = min(e0 + run, te);
    int mine = 0;
    for (int e = e0; e < e1; ++e) {
      const bool on = extract || t_valid[e] != 0;
      t_level[e] = on ? kUnplaced : -1;
      mine += on;
    }
    int n_on;
    block_exclusive_sum(mine, n_on);  // its barriers order the slots too
    if (stamps && lo == 0) trace[3] = clock64();
    int depth = 0;
    for (int placed = 0; placed < n_on; ++depth) {
      const unsigned key_base = (kLow - depth) << 16;
      for (int e = e0; e < e1; ++e) {
        if (t_level[e] != kUnplaced) continue;
        const unsigned key = key_base | e;
        const int a = slots[3 * e], b = slots[3 * e + 1], n = slots[3 * e + 2];
        atomicMin(&touch_key[a], key);
        atomicMin(&touch_key[b], key);
        if (n >= 0) atomicMin(&touch_key[n], key);
        if (t_valid[e] != 0) {
          atomicMin(&write_key[a], key);
          atomicMin(&write_key[b], key);
        }
      }
      __syncthreads();
      int ready = 0;
      for (int e = e0; e < e1; ++e) {
        if (t_level[e] != kUnplaced) continue;
        const unsigned key = key_base | e;
        const int a = slots[3 * e], b = slots[3 * e + 1], n = slots[3 * e + 2];
        // no earlier event left writes a row it touches, nor, when it
        // writes, touches a row it writes
        bool free = write_key[a] >= key && write_key[b] >= key &&
                    (n < 0 || write_key[n] >= key);
        if (t_valid[e] != 0) {
          free = free && touch_key[a] >= key && touch_key[b] >= key;
        }
        if (free) {
          t_level[e] = kReady;
          ++ready;
        }
      }
      int total;
      int at = placed + block_exclusive_sum(ready, total);
      for (int e = e0; e < e1; ++e) {
        if (t_level[e] != kReady) continue;
        t_level[e] = depth;
        order[at++] = e;
      }
      if (tid == 0) bounds[depth] = placed;
      placed += total;
      if (tid == 0) bounds[depth + 1] = placed;
    }
    if (stamps && lo == 0) trace[4] = clock64();
    __syncthreads();
    if (levels != nullptr && blockIdx.x == 0) {
      for (int e = tid; e < te; e += nt) {
        levels[lo + e] = t_level[e] < 0 ? -1 : base + t_level[e];
      }
    }
    return depth;
  };

  // the tile of events [lo, lo + te) and its plan, levels from `base`
  long long lo = 0;
  int te = tile_events(0, n_events, tile);
  int base = 0, tiles = 1;
  int depth = plan(lo, te, base);
  if (stamps) trace[5] = clock64();
  for (;;) {
    const bool last_tile = lo + te >= n_events;
    bool arrived = false;  // at the barrier after the tile's last level
    for (int v = 0; v < depth; ++v) {
      const int hi = bounds[v + 1];
      long long* row = trace + 5LL * (1 + base + v);
      for (int first = bounds[v]; first < hi; first += per_pass) {
        const int j = first + slot;
        if (j < hi) {  // the lane's warps agree
          const int e = order[j];
          const int s = t_src[e], d = t_dst[e];
          const long long g = lo + e;
          const float* gs = data + (long long)s * f;
          const float* gd = data + (long long)d * f;
          for (int x = lt; x < f; x += lane_threads) {
            cp_async4(&rows[x], gs + x);
            cp_async4(&rows[f + x], gd + x);
          }
          if (extract) {
            const float* gn = data + (long long)t_neg[e] * f;
            for (int x = lt; x < f; x += lane_threads) {
              cp_async4(&rows[2 * f + x], gn + x);
            }
          }
          cp_async_commit();
          const bool merges = t_valid[e] != 0;
          const float fresh_e = static_cast<float>(eidx[g]);
          const float fresh_t = ts[g];
          cp_async_wait_all();
          lane_sync(l, lane_threads);  // the rows are in
          if (stamps && first == bounds[v]) row[1] = clock64();
          if (extract) {
            float* out = ext + g * kRows * f;
            for (int x = lt; x < kRows * f; x += lane_threads) {
              out[x] = rows[x];
            }
          }
          if (merges) {
            const float* row1 = rows + dir * f;
            const float* row2 = rows + (1 - dir) * f;
            float* o = data + (long long)(dir == 0 ? s : d) * f;
            santa::merge_lane<Q, P>(
                row1 + member * 4 * k, row2 + member * 4 * k,
                row1[4 * m * k + member], coefs.alpha[member],
                coefs.beta[member], static_cast<float>(dir == 0 ? d : s),
                fresh_e, fresh_t, o + member * 4 * k, o + 4 * m * k + member,
                k);
          }
        }
        lane_sync(l, lane_threads);  // `rows` is free for the next pass
        if (stamps) row[2] = clock64();
      }
      if (last_tile && v + 1 == depth) {  // the chunk's end: no barrier
        if (stamps) row[3] = row[4] = clock64();
        break;
      }
      cluster_arrive();  // this level's writes are out
      if (stamps) row[3] = clock64();
      if (v + 1 == depth) {
        arrived = true;
        break;
      }
      cluster_wait();  // level v + 1 reads what level v wrote
      if (stamps) row[4] = clock64();
    }
    if (last_tile) break;
    // the next tile's plan while the other blocks arrive (a tile with no
    // level touched no row and owes no barrier)
    const long long next = lo + te;
    const int next_te = tile_events(next, n_events, tile);
    const int next_depth = plan(next, next_te, base + depth);
    if (stamps) trace[5LL * (1 + base + depth)] = clock64();
    if (arrived) {
      cluster_wait();
      if (stamps) trace[5LL * (base + depth) + 4] = clock64();
    }
    lo = next;
    te = next_te;
    base += depth;
    depth = next_depth;
    ++tiles;
  }
  if (stamps) {
    trace[1] = base + depth;
    trace[2] = tiles;
  }
}

}  // namespace

// data [N, F] f32, updated in place; src/dst/neg/eidx [E] i32, ts [E] f32,
// valid [E] u8; alpha/beta: m floats in HOST memory; ext [E, 3, F] f32 or
// null (no extraction: neg is not read). Ids must lie in [0, N). The
// geometry (index/scan.py:geometry): `cluster` blocks of `lanes` lanes,
// tiles of `tile` events, a hash table of `hash` slots (a power of two of
// at least 4·tile) and `smem_bytes` = smem_size(lanes, F, tile, hash) of
// shared memory. levels: null, or [E] i32 that block 0 fills with each
// event's level (-1 for an event that does nothing). trace: null, or
// [E + 1, 5] i64, zeroed, for the traced instantiation. Launches on
// `stream`; returns the first cudaError_t (0 = launched).
extern "C" int santa_scan(float* data, const int* src, const int* dst,
                          const int* neg, const int* eidx, const float* ts,
                          const unsigned char* valid, const float* alpha,
                          const float* beta, float* ext, long long n_events,
                          int m, int k, void* stream, int cluster, int lanes,
                          int tile, int hash, int smem_bytes, int* levels,
                          long long* trace) {
  const int f = m * (4 * k + 1);
  if (m < 1 || m > santa::kMaxM || k < 1 || k > santa::kMaxK ||
      n_events < 0 || cluster < 1 || cluster > kMaxCluster || lanes < 1 ||
      lanes * 64 * m > kMaxThreads || tile < 1 || tile > kMaxTile ||
      hash < 4 * tile || hash > kMaxHash || (hash & (hash - 1)) != 0 ||
      smem_bytes > kMaxSmem ||
      smem_bytes != smem_size(lanes, f, tile, hash)) {
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
    auto kernel = trace != nullptr ? santa_scan_kernel<kQ, kP, true>
                                   : santa_scan_kernel<kQ, kP, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    // a cluster the card cannot place is refused here (no occupancy query:
    // it would cost each observe call host time)
    err = cudaLaunchKernelEx(&cfg, kernel, data, src, dst, neg, eidx, ts,
                             valid, coefs, ext, n_events, m, k, lanes, tile,
                             hash, levels, trace);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  });
}
