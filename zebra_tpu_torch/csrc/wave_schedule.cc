// Greedy wave scheduler for the wave-parallel SANTA scan: host code, built
// with g++ and loaded with ctypes (zebra_tpu_torch/build.py). A copy of
// zebra_tpu/native/ingest.cc (schedule_impl, zt_wave_schedule_multi, and
// with n_shards > 1 zt_wave_schedule_aligned); the same inputs give the
// same (wave, slot, n_waves). zt_wave_redirects, the plan's list of
// same-wave writes after reads, is the port's own.
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

// The redirect list of a schedule laid out wave after wave (the plan of
// zebra_tpu_torch/index/waves.py; santa_waves.cu reads it): every negative
// that a lane reads from a row which a lane of the same wave writes. The
// rules above allow that writer to be the lane itself or a later lane of
// the wave, never an earlier one. order [n_sched] holds the stream
// positions of the scheduled events wave after wave, wave w being
// order[bounds[w]:bounds[w + 1]]; negs is [n, n_neg] row-major (one column
// per seed). Writes rows of 4 (writer's place in order, reader's stream
// position, negative slot, 0 when the writer's src row is read or 1 for
// its dst row; src for a self-loop) sorted by writer, then reader, then
// slot, into out (room for n_sched * n_neg rows); start [n_sched + 1], where
// each writer's rows start; mask [n_sched, n_neg], 1 where the reader at
// that place is named. Returns the number of rows, or -1 for an id outside
// [0, n_nodes).
extern "C" int64_t zt_wave_redirects(const int32_t* src, const int32_t* dst,
                                     const int32_t* negs, int32_t n_neg,
                                     const int64_t* order, int64_t n_sched,
                                     const int64_t* bounds, int32_t n_waves,
                                     int64_t n_nodes, int32_t* out,
                                     int32_t* start, uint8_t* mask) {
  // per node: the last wave that writes it, the writer's place, its row
  std::vector<int32_t> wave_of(static_cast<size_t>(n_nodes), -1);
  std::vector<int32_t> place(static_cast<size_t>(n_nodes), 0);
  std::vector<uint8_t> which(static_cast<size_t>(n_nodes), 0);
  std::vector<int64_t> hits;  // this wave's rows, by reader
  int64_t n_out = 0;
  for (int32_t w = 0; w < n_waves; ++w) {
    for (int64_t p = bounds[w]; p < bounds[w + 1]; ++p) {
      const int64_t e = order[p];
      const int32_t s = src[e], d = dst[e];
      if (s < 0 || s >= n_nodes || d < 0 || d >= n_nodes) return -1;
      wave_of[d] = w, place[d] = static_cast<int32_t>(p), which[d] = 1;
      wave_of[s] = w, place[s] = static_cast<int32_t>(p), which[s] = 0;
    }
    hits.clear();
    for (int64_t p = bounds[w]; p < bounds[w + 1]; ++p) {
      const int64_t e = order[p];
      for (int32_t r = 0; r < n_neg; ++r) {
        const int32_t g = negs[e * n_neg + r];
        if (g < 0 || g >= n_nodes) return -1;
        const bool hit = wave_of[g] == w;
        mask[p * n_neg + r] = hit;
        if (hit) hits.push_back(p * n_neg + r);
      }
    }
    // by writer; a stable sort keeps reader and slot order
    std::stable_sort(hits.begin(), hits.end(), [&](int64_t a, int64_t b) {
      return place[negs[order[a / n_neg] * n_neg + a % n_neg]] <
             place[negs[order[b / n_neg] * n_neg + b % n_neg]];
    });
    for (const int64_t h : hits) {
      const int64_t p = h / n_neg;
      const int32_t r = static_cast<int32_t>(h % n_neg);
      const int32_t g = negs[order[p] * n_neg + r];
      int32_t* row = out + 4 * n_out++;
      row[0] = place[g];
      row[1] = static_cast<int32_t>(order[p]);
      row[2] = r;
      row[3] = which[g];
    }
  }
  int64_t q = 0;
  for (int64_t j = 0; j <= n_sched; ++j) {
    while (q < n_out && out[4 * q] < j) ++q;
    start[j] = static_cast<int32_t>(q);
  }
  return n_out;
}
