// Greedy wave scheduler for the wave-parallel SANTA scan: host code, built
// with g++ and loaded with ctypes (zebra_tpu_torch/build.py). A copy of
// zebra_tpu/native/ingest.cc (schedule_impl, zt_wave_schedule_multi, and
// with n_shards > 1 zt_wave_schedule_aligned); the same inputs give the
// same (wave, slot, n_waves).
//
// Edge i reads the rows of src, dst and each of its n_neg negatives, and
// writes those of src and dst. Edges whose nodes are pairwise disjoint form
// one wave (all reads of a wave precede all its writes). Two per-node clocks
// place each edge in the earliest wave that respects every dependency:
//
//   wave(i) >= 1 + last_write[v]  for v in {src, dst, negatives}
//                                  (read/write after write)
//   wave(i) >= last_read[v]       for v in {src, dst}        (write after
//                                  read: it may share the reader's wave)
//
// then past waves that already hold `cap` edges. The lane (slot) of an edge
// is its wave's occupancy when it arrives, so the lanes of a wave are in
// stream order. The wave scan is then bit-equal to the sequential scan.
//
// The seed-parallel trainer runs one scan for all its seeds: each seed has
// its own negative stream, row s of negs [n_neg, n], and every seed's read
// is ordered against the writes. One stream gives the single-negative
// schedule.
//
// Owner-aligned (n_shards > 1, the row-sharded layout): the cap lanes of a
// wave split into n_shards blocks of cap / n_shards, and an edge takes a
// lane of the block of its src row's owner, owner(v) = v / ceil(n_nodes /
// n_shards) (contiguous rows per rank). The dependency rules are the same,
// so the scan stays bit-equal to the sequential one; a shard that holds
// many sources fills its block sooner and the wave count grows.

#include <algorithm>
#include <cstdint>
#include <vector>

// negs is [n_neg, n] row-major: one negative stream per seed.
extern "C" int64_t zt_wave_schedule_multi(const int32_t* src,
                                          const int32_t* dst,
                                          const int32_t* negs, int32_t n_neg,
                                          int64_t n, int64_t n_nodes,
                                          int32_t cap, int32_t n_shards,
                                          int32_t* wave_out,
                                          int32_t* slot_out) {
  if (n_shards < 1) n_shards = 1;
  if (cap < 1 || cap % n_shards != 0) return -2;  // blocks tile the lanes
  const int32_t block = cap / n_shards;
  const int64_t rows_per_shard = (n_nodes + n_shards - 1) / n_shards;
  std::vector<int32_t> last_write(static_cast<size_t>(n_nodes), -1);
  std::vector<int32_t> last_read(static_cast<size_t>(n_nodes), 0);
  std::vector<int32_t> count;  // occupancy per (wave, shard), stride n_shards
  count.reserve(1024);
  int32_t n_waves = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t s = src[i], d = dst[i];
    if (s < 0 || s >= n_nodes || d < 0 || d >= n_nodes) {
      return -1;  // id out of range: refuse rather than corrupt memory
    }
    int32_t w = std::max(last_write[s], last_write[d]);
    for (int32_t j = 0; j < n_neg; ++j) {
      const int32_t g = negs[static_cast<int64_t>(j) * n + i];
      if (g < 0 || g >= n_nodes) return -1;
      w = std::max(w, last_write[g]);
    }
    w = std::max({w + 1, last_read[s], last_read[d]});
    const int32_t own =
        n_shards > 1 ? static_cast<int32_t>(s / rows_per_shard) : 0;
    while (static_cast<size_t>(w) * n_shards < count.size() &&
           count[static_cast<size_t>(w) * n_shards + own] >= block)
      w++;
    if (static_cast<size_t>(w + 1) * n_shards > count.size())
      count.resize(static_cast<size_t>(w + 1) * n_shards, 0);
    wave_out[i] = w;
    slot_out[i] =
        own * block + count[static_cast<size_t>(w) * n_shards + own]++;
    last_write[s] = w;
    last_write[d] = w;
    if (w > last_read[s]) last_read[s] = w;
    if (w > last_read[d]) last_read[d] = w;
    for (int32_t j = 0; j < n_neg; ++j) {
      const int32_t g = negs[static_cast<int64_t>(j) * n + i];
      if (w > last_read[g]) last_read[g] = w;
    }
    if (w + 1 > n_waves) n_waves = w + 1;
  }
  return n_waves;
}
