// Native maze-trajectory generator: the host data-path hot loop (the port's
// copy of the JAX package's native/maze_gen.cpp, byte for byte below this
// header, so that both packages draw the same mazes).
//
// Shard generation: random occupancy mazes + A* shortest paths +
// arclength-uniform resampling, all in C++ behind a ctypes ABI
// (interpolated_diffusion_tpu_torch/data/native.py builds it with
// `g++ -O3 -shared -fPIC` on first use). One call fills a whole shard
// batch, ~10x faster than the numpy path.
//
// Determinism: seeded std::mt19937_64 per sample (seed + index), so shards
// are reproducible given (seed, index range) — same discipline as the
// Python generator (a different stream; both documented).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

namespace {

struct Node {
  int f, g, idx;
  bool operator>(const Node& o) const {
    return f > o.f || (f == o.f && g > o.g);
  }
};

// 4-connected A* with Manhattan heuristic; occ=1 is wall. Returns the path
// as cell indices (row-major) or empty on failure.
std::vector<int> astar(const std::vector<uint8_t>& occ, int h, int w,
                       int start, int goal) {
  const int n = h * w;
  std::vector<int> came(n, -1), g_score(n, INT32_MAX);
  std::vector<uint8_t> done(n, 0);
  auto heur = [&](int a) {
    int ai = a / w, aj = a % w, gi = goal / w, gj = goal % w;
    return std::abs(ai - gi) + std::abs(aj - gj);
  };
  std::priority_queue<Node, std::vector<Node>, std::greater<Node>> open;
  g_score[start] = 0;
  open.push({heur(start), 0, start});
  const int di[4] = {-1, 1, 0, 0};
  const int dj[4] = {0, 0, -1, 1};
  while (!open.empty()) {
    Node cur = open.top();
    open.pop();
    if (done[cur.idx]) continue;
    done[cur.idx] = 1;
    if (cur.idx == goal) {
      std::vector<int> path;
      for (int c = goal; c != -1; c = came[c]) path.push_back(c);
      std::reverse(path.begin(), path.end());
      return path;
    }
    int ci = cur.idx / w, cj = cur.idx % w;
    for (int d = 0; d < 4; ++d) {
      int ni = ci + di[d], nj = cj + dj[d];
      if (ni < 0 || nj < 0 || ni >= h || nj >= w) continue;
      int nidx = ni * w + nj;
      if (occ[nidx]) continue;
      int ng = cur.g + 1;
      if (ng < g_score[nidx]) {
        g_score[nidx] = ng;
        came[nidx] = cur.idx;
        open.push({ng + heur(nidx), ng, nidx});
      }
    }
  }
  return {};
}

// Arclength-uniform resampling of the cell-center polyline to T points.
void resample(const std::vector<int>& path, int h, int w, int T,
              bool with_velocity, float* out /* [T, 2 or 4] */) {
  const int P = static_cast<int>(path.size());
  std::vector<float> xs(P), ys(P), cum(P, 0.0f);
  for (int p = 0; p < P; ++p) {
    xs[p] = (path[p] % w + 0.5f) / w;
    ys[p] = (path[p] / w + 0.5f) / h;
    if (p > 0) {
      float dx = xs[p] - xs[p - 1], dy = ys[p] - ys[p - 1];
      cum[p] = cum[p - 1] + std::sqrt(dx * dx + dy * dy);
    }
  }
  const int D = with_velocity ? 4 : 2;
  float total = cum[P - 1];
  for (int t = 0; t < T; ++t) {
    float s = (P > 1 && total > 1e-8f)
                  ? total * static_cast<float>(t) / (T - 1)
                  : 0.0f;
    int seg = static_cast<int>(
        std::upper_bound(cum.begin(), cum.end(), s) - cum.begin()) - 1;
    seg = std::max(0, std::min(seg, P - 2));
    float len = cum[seg + 1] - cum[seg];
    float a = len > 1e-8f ? (s - cum[seg]) / len : 0.0f;
    out[t * D + 0] = xs[seg] + a * (xs[seg + 1] - xs[seg]);
    out[t * D + 1] = ys[seg] + a * (ys[seg + 1] - ys[seg]);
  }
  if (with_velocity) {
    float dt = 1.0f / T;
    for (int t = 0; t < T; ++t) {
      if (t < T - 1) {
        out[t * 4 + 2] = (out[(t + 1) * 4 + 0] - out[t * 4 + 0]) / dt;
        out[t * 4 + 3] = (out[(t + 1) * 4 + 1] - out[t * 4 + 1]) / dt;
      } else {
        out[t * 4 + 2] = 0.0f;
        out[t * 4 + 3] = 0.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

// Generate n maze-trajectory samples.
//   x_out   [n, T, D]   (D = with_velocity ? 4 : 2)
//   occ_out [n, h, w]
//   sg_out  [n, 4]      (start_xy, goal_xy in [0,1])
// Returns the number of samples generated (== n unless generation failed).
int generate_maze_batch(uint64_t seed, int n, int h, int w, float p_wall_min,
                        float p_wall_max, int T, int with_velocity,
                        float* x_out, float* occ_out, float* sg_out) {
  const int D = with_velocity ? 4 : 2;
  const int cells = h * w;
  const int min_l1 = h / 2;
  for (int i = 0; i < n; ++i) {
    std::mt19937_64 rng(seed + static_cast<uint64_t>(i));
    std::uniform_real_distribution<float> uni(0.0f, 1.0f);
    float p_wall = p_wall_min + (p_wall_max - p_wall_min) * uni(rng);
    bool ok = false;
    for (int attempt = 0; attempt < 100 && !ok; ++attempt) {
      std::vector<uint8_t> occ(cells);
      std::vector<int> free_cells;
      free_cells.reserve(cells);
      for (int c = 0; c < cells; ++c) {
        occ[c] = uni(rng) < p_wall ? 1 : 0;
        if (!occ[c]) free_cells.push_back(c);
      }
      if (free_cells.size() < 2) continue;
      int start = free_cells[static_cast<size_t>(uni(rng) * free_cells.size())
                             % free_cells.size()];
      int goal = free_cells[static_cast<size_t>(uni(rng) * free_cells.size())
                            % free_cells.size()];
      int l1 = std::abs(start / w - goal / w) + std::abs(start % w - goal % w);
      if (l1 < min_l1) continue;
      // boundary walls, keeping start/goal free
      for (int j = 0; j < w; ++j) { occ[j] = 1; occ[(h - 1) * w + j] = 1; }
      for (int r = 0; r < h; ++r) { occ[r * w] = 1; occ[r * w + w - 1] = 1; }
      occ[start] = 0;
      occ[goal] = 0;
      std::vector<int> path = astar(occ, h, w, start, goal);
      if (path.empty()) continue;
      resample(path, h, w, T, with_velocity, x_out + i * T * D);
      for (int c = 0; c < cells; ++c)
        occ_out[i * cells + c] = static_cast<float>(occ[c]);
      sg_out[i * 4 + 0] = (start % w + 0.5f) / w;
      sg_out[i * 4 + 1] = (start / w + 0.5f) / h;
      sg_out[i * 4 + 2] = (goal % w + 0.5f) / w;
      sg_out[i * 4 + 3] = (goal / w + 0.5f) / h;
      ok = true;
    }
    if (!ok) return i;
  }
  return n;
}

}  // extern "C"
