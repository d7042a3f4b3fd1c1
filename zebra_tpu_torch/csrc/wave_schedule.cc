// Greedy wave scheduler for the wave-parallel SANTA scan: host code, built
// with g++ and loaded with ctypes (zebra_tpu_torch/build.py). A copy of the
// one-shard case of zebra_tpu/native/ingest.cc (schedule_impl,
// zt_wave_schedule_multi); the same inputs give the same (wave, slot,
// n_waves).
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

#include <algorithm>
#include <cstdint>
#include <vector>

// negs is [n_neg, n] row-major: one negative stream per seed.
extern "C" int64_t zt_wave_schedule_multi(const int32_t* src,
                                          const int32_t* dst,
                                          const int32_t* negs, int32_t n_neg,
                                          int64_t n, int64_t n_nodes,
                                          int32_t cap, int32_t* wave_out,
                                          int32_t* slot_out) {
  if (cap < 1) return -2;
  std::vector<int32_t> last_write(static_cast<size_t>(n_nodes), -1);
  std::vector<int32_t> last_read(static_cast<size_t>(n_nodes), 0);
  std::vector<int32_t> count;  // occupancy per wave
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
    while (static_cast<size_t>(w) < count.size() && count[w] >= cap) w++;
    if (static_cast<size_t>(w) >= count.size()) count.resize(w + 1, 0);
    wave_out[i] = w;
    slot_out[i] = count[w]++;
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
