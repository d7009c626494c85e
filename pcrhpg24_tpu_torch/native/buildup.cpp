// CPU octree point-buildup strategy bench (libbuildup.so): a copy of
// pcrhpg24_tpu/native/buildup.cpp.
//
// Port of the reference's main_buildup_perf executable
// (src/main_buildup_perf.cpp + include/perf/*.h): ingest LAS points
// into a capacity-split octree under different strategies and measure
// points/sec.  The reference compares pointwise adds, batched
// counting-sort partition, a multithreaded batch pipeline and
// morton-ordered ingestion; this is the same experiment as an
// independent implementation (the strategies are the subject, the
// octree is the apparatus).  Off the render path — a host-side
// engineering bench, like upstream.
//
// Exported (ctypes):
//   buildup_run(xyz f64*[n*3], n, bbox f64[6], strategy, threads,
//               out_stats i64[4])  -> 0
//     strategy: 0 pointwise, 1 batched, 2 batched multithreaded,
//               3 morton-ordered batched
//     out_stats: {nodes, leaf_points, max_depth, reserved}

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int kCapacity = 100'000;  // leaf split threshold
constexpr int kMaxDepth = 20;

struct Node {
  double min[3], max[3];
  std::vector<double> pts;  // xyz interleaved (leaf storage)
  Node* children[8] = {nullptr, nullptr, nullptr, nullptr,
                       nullptr, nullptr, nullptr, nullptr};
  bool is_leaf = true;
  int depth = 0;
  std::mutex mtx;  // used by the multithreaded strategy
};

int octant(const Node& n, const double* p) {
  double cx = 0.5 * (n.min[0] + n.max[0]);
  double cy = 0.5 * (n.min[1] + n.max[1]);
  double cz = 0.5 * (n.min[2] + n.max[2]);
  return (p[0] >= cx ? 1 : 0) | (p[1] >= cy ? 2 : 0) | (p[2] >= cz ? 4 : 0);
}

Node* make_child(Node& n, int idx) {
  Node* c = new Node();
  c->depth = n.depth + 1;
  for (int a = 0; a < 3; a++) {
    double mid = 0.5 * (n.min[a] + n.max[a]);
    bool hi = (idx >> a) & 1;
    c->min[a] = hi ? mid : n.min[a];
    c->max[a] = hi ? n.max[a] : mid;
  }
  return c;
}

void split(Node& n) {
  n.is_leaf = false;
  for (int i = 0; i < 8; i++) n.children[i] = make_child(n, i);
  std::vector<double> pts;
  pts.swap(n.pts);
  for (size_t i = 0; i < pts.size(); i += 3) {
    Node* c = n.children[octant(n, &pts[i])];
    c->pts.insert(c->pts.end(), &pts[i], &pts[i] + 3);
  }
  // children over capacity split lazily on their next insert
}

void add_point(Node& n, const double* p) {
  Node* cur = &n;
  while (!cur->is_leaf) cur = cur->children[octant(*cur, p)];
  cur->pts.insert(cur->pts.end(), p, p + 3);
  if (cur->pts.size() / 3 > kCapacity && cur->depth < kMaxDepth) split(*cur);
}

// batched: counting-sort the batch by octant at each level, recurse on
// contiguous sub-ranges (perf/add_batched.h's partition scheme)
void add_batch(Node& n, double* xyz, int64_t count) {
  if (n.is_leaf) {
    if (n.pts.size() / 3 + count <= kCapacity || n.depth >= kMaxDepth) {
      n.pts.insert(n.pts.end(), xyz, xyz + 3 * count);
      return;
    }
    split(n);
  }
  int64_t counters[8] = {0};
  std::vector<uint8_t> oct(count);
  for (int64_t i = 0; i < count; i++) {
    oct[i] = (uint8_t)octant(n, xyz + 3 * i);
    counters[oct[i]]++;
  }
  int64_t offsets[8], acc = 0;
  for (int i = 0; i < 8; i++) { offsets[i] = acc; acc += counters[i]; }
  std::vector<double> tmp(3 * count);
  int64_t cursor[8];
  std::memcpy(cursor, offsets, sizeof(cursor));
  for (int64_t i = 0; i < count; i++)
    std::memcpy(&tmp[3 * cursor[oct[i]]++], xyz + 3 * i, 3 * sizeof(double));
  std::memcpy(xyz, tmp.data(), tmp.size() * sizeof(double));
  for (int i = 0; i < 8; i++)
    if (counters[i]) add_batch(*n.children[i], xyz + 3 * offsets[i],
                               counters[i]);
}

void stats(Node& n, int64_t* nodes, int64_t* leaf_pts, int64_t* maxd) {
  (*nodes)++;
  if (n.depth > *maxd) *maxd = n.depth;
  if (n.is_leaf) { *leaf_pts += (int64_t)(n.pts.size() / 3); return; }
  for (int i = 0; i < 8; i++) stats(*n.children[i], nodes, leaf_pts, maxd);
}

void free_tree(Node& n) {
  for (int i = 0; i < 8; i++)
    if (n.children[i]) { free_tree(*n.children[i]); delete n.children[i]; }
}

uint64_t morton_key(const double* p, const double* bmin,
                    const double* inv_ext) {
  uint64_t k = 0;
  uint32_t g[3];
  for (int a = 0; a < 3; a++) {
    double t = (p[a] - bmin[a]) * inv_ext[a];
    if (t < 0) t = 0;
    if (t > 1) t = 1;
    g[a] = (uint32_t)(t * 2097151.0);  // 21 bits
  }
  for (int b = 0; b < 21; b++)
    for (int a = 0; a < 3; a++)
      k |= (uint64_t)((g[a] >> b) & 1) << (3 * b + a);
  return k;
}

}  // namespace

extern "C" int buildup_run(double* xyz, int64_t n, const double* bbox,
                           int strategy, int threads, int64_t* out_stats) {
  Node root;
  for (int a = 0; a < 3; a++) { root.min[a] = bbox[a]; root.max[a] = bbox[3 + a]; }

  constexpr int64_t kBatch = 1'000'000;
  if (strategy == 0) {
    for (int64_t i = 0; i < n; i++) add_point(root, xyz + 3 * i);
  } else if (strategy == 1) {
    for (int64_t s = 0; s < n; s += kBatch)
      add_batch(root, xyz + 3 * s, std::min(kBatch, n - s));
  } else if (strategy == 2) {
    // batchwise multithreaded (perf/batchwise_multithreaded.h):
    // each worker partitions its batch by TOP-LEVEL octant locally,
    // then appends each part under that child's lock — contention is
    // per-octant, not per-tree
    if (!root.is_leaf || n > 0) split(root);
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
      for (;;) {
        int64_t s = next.fetch_add(kBatch);
        if (s >= n) return;
        int64_t cnt = std::min(kBatch, n - s);
        std::vector<std::vector<double>> parts(8);
        for (int64_t i = 0; i < cnt; i++) {
          double* p = xyz + 3 * (s + i);
          parts[octant(root, p)].insert(
              parts[octant(root, p)].end(), p, p + 3);
        }
        for (int o = 0; o < 8; o++) {
          if (parts[o].empty()) continue;
          Node& c = *root.children[o];
          std::lock_guard<std::mutex> g(c.mtx);
          add_batch(c, parts[o].data(), (int64_t)(parts[o].size() / 3));
        }
      }
    };
    std::vector<std::thread> ts;
    for (int t = 0; t < std::max(1, threads); t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  } else if (strategy == 3) {
    // morton-ordered (perf/add_morton_multithreaded.h): sort batches
    // by morton key first; spatial coherence keeps each add_batch
    // recursion in a narrow subtree
    std::vector<std::pair<uint64_t, int64_t>> keys(n);
    double inv_ext[3];
    for (int a = 0; a < 3; a++)
      inv_ext[a] = 1.0 / std::max(1e-12, bbox[3 + a] - bbox[a]);
    for (int64_t i = 0; i < n; i++)
      keys[i] = {morton_key(xyz + 3 * i, bbox, inv_ext), i};
    std::sort(keys.begin(), keys.end());
    std::vector<double> sorted(3 * n);
    for (int64_t i = 0; i < n; i++)
      std::memcpy(&sorted[3 * i], xyz + 3 * keys[i].second,
                  3 * sizeof(double));
    std::memcpy(xyz, sorted.data(), sorted.size() * sizeof(double));
    for (int64_t s = 0; s < n; s += kBatch)
      add_batch(root, xyz + 3 * s, std::min(kBatch, n - s));
  } else {
    return 1;
  }

  int64_t nodes = 0, leaf_pts = 0, maxd = 0;
  stats(root, &nodes, &leaf_pts, &maxd);
  out_stats[0] = nodes;
  out_stats[1] = leaf_pts;
  out_stats[2] = maxd;
  out_stats[3] = 0;
  free_tree(root);
  return 0;
}
