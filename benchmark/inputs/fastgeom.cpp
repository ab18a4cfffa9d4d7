// Frozen copy of csrc/fastgeom.cpp at commit 57ee902 (the point-cloud
// generators' native Bridson sampler), kept with the benchmark so that the
// inputs it makes from a seed do not move when the program's copy changes.
// The benchmark builds it with g++ into its own git-ignored build/ folder
// and calls fg_poisson_disk only.
//
// Native geometry kernels for setup-time hot paths.
//
// The solve path is JAX/Pallas on TPU; these C++ routines replace the
// Python-loop host preprocessing that dominates setup at large N
// (SURVEY.md section 7: the preprocessor is a first-class component —
// the reference's equivalents are Grid::kNearestNeighbors' O(N^2) scans,
// grid.cpp:216-260, and rcm_order_points, grid.cpp:713-776).
//
// Exposed via a C ABI for ctypes (no pybind11 in the image):
//   fg_poisson_disk : Bridson blue-noise sampling with boundary clearance
//   fg_knn          : cell-grid k-nearest-neighbor tables (2D)
//   fg_block_color  : capped balanced in-block coloring permutation
//
// Build: g++ -O3 -march=native -shared -fPIC fastgeom.cpp -o libfastgeom.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Bridson Poisson-disk sampling in [0,1]^2 minus a keep-out set.
// keep_fn is approximated by an optional hole (circle) and boundary points
// with a clearance radius.  Returns the number of samples written (< cap).
// ---------------------------------------------------------------------------
int64_t fg_poisson_disk(
    double r,                 // min pair distance
    uint64_t seed,
    const double* bpts,       // [nb, 2] boundary points (clearance keep-out)
    int64_t nb,
    double clearance,         // min distance to any boundary point
    double hole_cx, double hole_cy, double hole_r,  // hole_r<=0: no hole
    double ann_r_in, double ann_r_out,              // annulus; <=0: off
    double* out,              // [cap, 2]
    int64_t cap) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> uni(0.0, 1.0);

  const double cell = r / std::sqrt(2.0);
  const int64_t dims = std::max<int64_t>(1, (int64_t)(1.0 / cell) + 1);
  std::vector<int64_t> grid((size_t)dims * dims, -1);
  std::vector<double> sx, sy;
  sx.reserve(cap);
  sy.reserve(cap);
  std::vector<int64_t> active;

  // boundary keep-out grid (coarse cells of size `clearance`)
  const double bcell = std::max(clearance, 1e-9);
  const int64_t bdims = std::max<int64_t>(1, (int64_t)(1.0 / bcell) + 2);
  std::vector<std::vector<int32_t>> bgrid((size_t)bdims * bdims);
  for (int64_t i = 0; i < nb; i++) {
    int64_t cx = std::min<int64_t>(bdims - 1, (int64_t)(bpts[2 * i] / bcell));
    int64_t cy = std::min<int64_t>(bdims - 1, (int64_t)(bpts[2 * i + 1] / bcell));
    bgrid[(size_t)(cx * bdims + cy)].push_back((int32_t)i);
  }

  auto domain_ok = [&](double x, double y) -> bool {
    if (x <= 0.0 || x >= 1.0 || y <= 0.0 || y >= 1.0) return false;
    if (hole_r > 0.0) {
      double dx = x - hole_cx, dy = y - hole_cy;
      if (dx * dx + dy * dy <= hole_r * hole_r) return false;
    }
    if (ann_r_out > 0.0) {
      double dx = x - 0.5, dy = y - 0.5;
      double rr = dx * dx + dy * dy;
      if (rr <= ann_r_in * ann_r_in || rr >= ann_r_out * ann_r_out)
        return false;
    }
    if (nb > 0) {
      int64_t cx = std::min<int64_t>(bdims - 1, (int64_t)(x / bcell));
      int64_t cy = std::min<int64_t>(bdims - 1, (int64_t)(y / bcell));
      for (int64_t gx = std::max<int64_t>(0, cx - 1);
           gx <= std::min(bdims - 1, cx + 1); gx++)
        for (int64_t gy = std::max<int64_t>(0, cy - 1);
             gy <= std::min(bdims - 1, cy + 1); gy++)
          for (int32_t j : bgrid[(size_t)(gx * bdims + gy)]) {
            double dx = x - bpts[2 * j], dy = y - bpts[2 * j + 1];
            if (dx * dx + dy * dy < clearance * clearance) return false;
          }
    }
    return true;
  };

  auto far_enough = [&](double x, double y) -> bool {
    int64_t cx = std::min(dims - 1, (int64_t)(x / cell));
    int64_t cy = std::min(dims - 1, (int64_t)(y / cell));
    for (int64_t gx = std::max<int64_t>(0, cx - 2);
         gx <= std::min(dims - 1, cx + 2); gx++)
      for (int64_t gy = std::max<int64_t>(0, cy - 2);
           gy <= std::min(dims - 1, cy + 2); gy++) {
        int64_t s = grid[(size_t)(gx * dims + gy)];
        if (s >= 0) {
          double dx = sx[(size_t)s] - x, dy = sy[(size_t)s] - y;
          if (dx * dx + dy * dy < r * r) return false;
        }
      }
    return true;
  };

  auto put = [&](double x, double y) {
    int64_t id = (int64_t)sx.size();
    sx.push_back(x);
    sy.push_back(y);
    int64_t cx = std::min(dims - 1, (int64_t)(x / cell));
    int64_t cy = std::min(dims - 1, (int64_t)(y / cell));
    grid[(size_t)(cx * dims + cy)] = id;
    active.push_back(id);
  };

  // seed point
  for (int tries = 0; tries < 10000; tries++) {
    double x = uni(rng), y = uni(rng);
    if (domain_ok(x, y) && far_enough(x, y)) {
      put(x, y);
      break;
    }
  }

  const double tau = 6.283185307179586;
  while (!active.empty() && (int64_t)sx.size() < cap) {
    size_t ai = (size_t)(uni(rng) * active.size());
    if (ai >= active.size()) ai = active.size() - 1;
    int64_t base = active[ai];
    bool placed = false;
    for (int t = 0; t < 30 && (int64_t)sx.size() < cap; t++) {
      double rad = r * (1.0 + uni(rng));
      double th = tau * uni(rng);
      double x = sx[(size_t)base] + rad * std::cos(th);
      double y = sy[(size_t)base] + rad * std::sin(th);
      if (domain_ok(x, y) && far_enough(x, y)) {
        put(x, y);
        placed = true;
      }
    }
    if (!placed) {
      active[ai] = active.back();
      active.pop_back();
    }
  }

  int64_t n = (int64_t)sx.size();
  for (int64_t i = 0; i < n; i++) {
    out[2 * i] = sx[(size_t)i];
    out[2 * i + 1] = sy[(size_t)i];
  }
  return n;
}

// ---------------------------------------------------------------------------
// Cell-grid kNN (2D): for each query, the k nearest of `points`.
// Optional candidate mask (exclude points where mask==0); self-inclusion is
// the caller's business (queries drawn from points find themselves at d=0).
// ---------------------------------------------------------------------------
void fg_knn(
    const double* pts, int64_t n,
    const double* qry, int64_t m,
    int64_t k,
    const uint8_t* candidate_mask,  // [n] or NULL
    int32_t* out_idx  /* [m, k] */) {
  // bounding box + cell size targeting ~2 candidates per cell
  double lox = 1e300, loy = 1e300, hix = -1e300, hiy = -1e300;
  for (int64_t i = 0; i < n; i++) {
    lox = std::min(lox, pts[2 * i]);
    hix = std::max(hix, pts[2 * i]);
    loy = std::min(loy, pts[2 * i + 1]);
    hiy = std::max(hiy, pts[2 * i + 1]);
  }
  double span = std::max(std::max(hix - lox, hiy - loy), 1e-12);
  int64_t dims = std::max<int64_t>(1, (int64_t)std::sqrt((double)n / 2.0));
  double cell = span / (double)dims;

  std::vector<int32_t> cell_of((size_t)n);
  std::vector<int64_t> count((size_t)dims * dims + 1, 0);
  auto cell_id = [&](double x, double y) -> int64_t {
    int64_t cx = std::min<int64_t>(dims - 1,
                                   std::max<int64_t>(0, (int64_t)((x - lox) / cell)));
    int64_t cy = std::min<int64_t>(dims - 1,
                                   std::max<int64_t>(0, (int64_t)((y - loy) / cell)));
    return cx * dims + cy;
  };
  for (int64_t i = 0; i < n; i++) {
    int64_t c = cell_id(pts[2 * i], pts[2 * i + 1]);
    cell_of[(size_t)i] = (int32_t)c;
    count[(size_t)c + 1]++;
  }
  for (size_t c = 1; c < count.size(); c++) count[c] += count[c - 1];
  std::vector<int32_t> items((size_t)n);
  {
    std::vector<int64_t> cur(count.begin(), count.end() - 1);
    for (int64_t i = 0; i < n; i++)
      items[(size_t)cur[(size_t)cell_of[(size_t)i]]++] = (int32_t)i;
  }

  typedef std::pair<double, int32_t> DI;
  std::vector<DI> heap;
  heap.reserve((size_t)k + 1);
  for (int64_t q = 0; q < m; q++) {
    double qx = qry[2 * q], qy = qry[2 * q + 1];
    heap.clear();
    int64_t ring = 0;
    int64_t qcx = std::min<int64_t>(dims - 1,
                                    std::max<int64_t>(0, (int64_t)((qx - lox) / cell)));
    int64_t qcy = std::min<int64_t>(dims - 1,
                                    std::max<int64_t>(0, (int64_t)((qy - loy) / cell)));
    while (true) {
      // scan cells on ring `ring`
      bool any_cell = false;
      for (int64_t cx = qcx - ring; cx <= qcx + ring; cx++) {
        if (cx < 0 || cx >= dims) continue;
        for (int64_t cy = qcy - ring; cy <= qcy + ring; cy++) {
          if (cy < 0 || cy >= dims) continue;
          if (std::max(std::llabs(cx - qcx), std::llabs(cy - qcy)) != ring)
            continue;
          any_cell = true;
          for (int64_t ii = count[(size_t)(cx * dims + cy)];
               ii < count[(size_t)(cx * dims + cy) + 1]; ii++) {
            int32_t j = items[(size_t)ii];
            if (candidate_mask && !candidate_mask[j]) continue;
            double dx = pts[2 * j] - qx, dy = pts[2 * j + 1] - qy;
            double d2 = dx * dx + dy * dy;
            if ((int64_t)heap.size() < k) {
              heap.emplace_back(d2, j);
              std::push_heap(heap.begin(), heap.end());
            } else if (d2 < heap.front().first) {
              std::pop_heap(heap.begin(), heap.end());
              heap.back() = DI(d2, j);
              std::push_heap(heap.begin(), heap.end());
            }
          }
        }
      }
      // stop when the heap is full and the ring is beyond the kth distance
      if ((int64_t)heap.size() >= k) {
        double ring_dist = (double)ring * cell;  // conservative lower bound
        if (ring_dist * ring_dist > heap.front().first) break;
      }
      ring++;
      if (ring > 2 * dims && !any_cell) break;  // safety
      if (ring > 2 * dims) break;
    }
    std::sort_heap(heap.begin(), heap.end());
    for (int64_t j = 0; j < k; j++)
      out_idx[q * k + j] =
          (j < (int64_t)heap.size()) ? heap[(size_t)j].second : (int32_t)(q % n);
  }
}

// ---------------------------------------------------------------------------
// Capped balanced in-block coloring (geometry/coloring.py semantics).
// adjacency: CSR (symmetrized) of the coupling pattern.
// Writes perm [n]; returns the number of residual conflicts.
// ---------------------------------------------------------------------------
int64_t fg_block_color(
    const int64_t* indptr, const int32_t* indices, int64_t n,
    int64_t block_rows, int64_t class_size,
    int64_t* perm) {
  const int64_t nc = block_rows / class_size;
  std::vector<int64_t> colors((size_t)block_rows);
  std::vector<int64_t> counts((size_t)nc);
  std::vector<uint8_t> used((size_t)nc);
  int64_t conflicts = 0;
  int64_t block_conflicts = 0;

  for (int64_t s = 0; s < n; s += block_rows) {
    int64_t e = std::min(s + block_rows, n);
    int64_t nb = e - s;
    int64_t cap = (nb < block_rows) ? (nb + nc - 1) / nc : class_size;
    std::fill(counts.begin(), counts.end(), 0);
    for (int64_t i = 0; i < nb; i++) {
      std::fill(used.begin(), used.end(), 0);
      for (int64_t p = indptr[s + i]; p < indptr[s + i + 1]; p++) {
        int64_t j = indices[p] - s;
        if (j >= 0 && j < i) used[(size_t)colors[(size_t)j]] = 1;
      }
      int64_t best = -1, best_cnt = block_rows + 1;
      for (int64_t c = 0; c < nc; c++)
        if (!used[(size_t)c] && counts[(size_t)c] < cap &&
            counts[(size_t)c] < best_cnt) {
          best = c;
          best_cnt = counts[(size_t)c];
        }
      if (best < 0) {
        // repair: find a class c with space whose conflict with row i can
        // be resolved by relocating one earlier member j to another class
        // where j itself has no conflicts and space remains.
        for (int64_t c = 0; c < nc && best < 0; c++) {
          if (counts[(size_t)c] >= cap) continue;
          // members of c conflicting with i
          int64_t bad = -1, nbad = 0;
          for (int64_t p = indptr[s + i]; p < indptr[s + i + 1]; p++) {
            int64_t j = indices[p] - s;
            if (j >= 0 && j < i && colors[(size_t)j] == c) {
              bad = j;
              nbad++;
            }
          }
          if (nbad != 1) continue;  // single-conflict classes only
          // where can `bad` go?  needs: space, no conflict for bad, and
          // not class c
          std::fill(used.begin(), used.end(), 0);
          for (int64_t p = indptr[s + bad]; p < indptr[s + bad + 1]; p++) {
            int64_t j = indices[p] - s;
            if (j >= 0 && j < nb && j != bad && colors[(size_t)j] >= 0)
              used[(size_t)colors[(size_t)j]] = 1;
          }
          for (int64_t c2 = 0; c2 < nc; c2++) {
            if (c2 == c || used[(size_t)c2] || counts[(size_t)c2] >= cap)
              continue;
            colors[(size_t)bad] = c2;
            counts[(size_t)c2]++;
            counts[(size_t)c]--;
            best = c;
            break;
          }
        }
        if (best < 0) {
          // recompute i's conflict set (used[] was clobbered above)
          std::fill(used.begin(), used.end(), 0);
          for (int64_t p = indptr[s + i]; p < indptr[s + i + 1]; p++) {
            int64_t j = indices[p] - s;
            if (j >= 0 && j < i) used[(size_t)colors[(size_t)j]] = 1;
          }
          // last resort: least-conflicted class with space
          int64_t best_conf = block_rows + 1;
          for (int64_t c = 0; c < nc; c++) {
            if (counts[(size_t)c] >= cap) continue;
            int64_t nconf = 0;
            for (int64_t p = indptr[s + i]; p < indptr[s + i + 1]; p++) {
              int64_t j = indices[p] - s;
              if (j >= 0 && j < i && colors[(size_t)j] == c) nconf++;
            }
            if (nconf < best_conf ||
                (nconf == best_conf && counts[(size_t)c] < best_cnt)) {
              best = c;
              best_conf = nconf;
              best_cnt = counts[(size_t)c];
            }
          }
          conflicts += best_conf;
        }
      }
      colors[(size_t)i] = best;
      counts[(size_t)best]++;
    }
    // ---- equitable-swap post-pass -------------------------------------
    // Hajnal-Szemeredi: an equitable nc-coloring exists whenever the
    // in-block degree is < nc, so a local search over (conflicted row,
    // partner row) swaps removes almost every greedy spill; only rows
    // whose in-block degree reaches nc (condensation-widened Neumann
    // neighborhoods) can remain, and those are counted below.
    {
      auto conf_as = [&](int64_t i, int64_t c, int64_t skip) -> int64_t {
        int64_t n = 0;
        for (int64_t p = indptr[s + i]; p < indptr[s + i + 1]; p++) {
          int64_t j = indices[p] - s;
          if (j >= 0 && j < nb && j != i && j != skip &&
              colors[(size_t)j] == c)
            n++;
        }
        return n;
      };
      for (int pass = 0; pass < 8; pass++) {
        bool improved = false;
        for (int64_t i = 0; i < nb; i++) {
          int64_t ci = colors[(size_t)i];
          int64_t bad = conf_as(i, ci, -1);
          if (bad == 0) continue;
          // direct move into a class with space
          bool done = false;
          for (int64_t c2 = 0; c2 < nc && !done; c2++) {
            if (c2 == ci || counts[(size_t)c2] >= cap) continue;
            if (conf_as(i, c2, -1) == 0) {
              colors[(size_t)i] = c2;
              counts[(size_t)c2]++;
              counts[(size_t)ci]--;
              improved = done = true;
            }
          }
          // swap with a partner row j
          for (int64_t j = 0; j < nb && !done; j++) {
            int64_t cj = colors[(size_t)j];
            if (cj == ci) continue;
            if (conf_as(i, cj, j) == 0 &&
                conf_as(j, ci, i) == 0) {
              colors[(size_t)i] = cj;
              colors[(size_t)j] = ci;
              improved = done = true;
            }
          }
        }
        if (!improved) break;
      }
      // recount this block's residual conflicting pairs (each pair once);
      // the greedy-phase spill counts are superseded by this exact count
      int64_t blk_conf = 0;
      for (int64_t i = 0; i < nb; i++)
        for (int64_t p = indptr[s + i]; p < indptr[s + i + 1]; p++) {
          int64_t j = indices[p] - s;
          if (j > i && j < nb && colors[(size_t)j] == colors[(size_t)i])
            blk_conf++;
        }
      block_conflicts += blk_conf;
    }
    // stable class-major order
    std::vector<int64_t> order((size_t)nb);
    for (int64_t i = 0; i < nb; i++) order[(size_t)i] = i;
    std::stable_sort(order.begin(), order.begin() + nb,
                     [&](int64_t a, int64_t b) {
                       return colors[(size_t)a] < colors[(size_t)b];
                     });
    for (int64_t i = 0; i < nb; i++) perm[s + i] = s + order[(size_t)i];
  }
  (void)conflicts;  // greedy spill counter superseded by the exact recount
  return block_conflicts;
}

}  // extern "C"
