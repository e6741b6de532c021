// Native BVH builder: binned SAH over primitive AABBs.
//
// The performance-critical host-side preprocess of the framework (the
// reference builds its flat BVHs in Julia:
// /root/reference/examples/julia-raytracer-optimized.jl:1327-1419,
// /root/reference/examples/spira-metal-raytracer.jl:346-487).  This builder
// upgrades the median-split heuristic to binned surface-area-heuristic
// splits (16 bins) for better traversal trees on large meshes, while
// emitting the exact flat layout of spira_tpu.accel.bvh.FlatBVH:
//   internal node i: left[i]/right[i] = child node indices, is_leaf[i]=0
//   leaf node i:     left[i] = first index into prim_idx, right[i] = count,
//                    is_leaf[i]=1
//
// C ABI for ctypes (see spira_tpu/accel/native.py).  Single-threaded,
// iterative (explicit stack), no exceptions across the boundary.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kBins = 16;
constexpr int kMaxStack = 64;  // must match accel.bvh.MAX_STACK

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity()};
  Vec3 hi{-std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity()};
  void grow(const AABB &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float half_area() const {
    float dx = std::max(0.0f, hi.x - lo.x);
    float dy = std::max(0.0f, hi.y - lo.y);
    float dz = std::max(0.0f, hi.z - lo.z);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct BuildState {
  const float *lo;  // (n, 3)
  const float *hi;
  std::vector<Vec3> centroid;
  std::vector<int32_t> order;
  // output arrays (grown as nodes are allocated)
  std::vector<float> node_min, node_max;
  std::vector<int32_t> left, right, is_leaf;

  AABB prim_box(int32_t p) const {
    AABB b;
    b.lo = {lo[3 * p], lo[3 * p + 1], lo[3 * p + 2]};
    b.hi = {hi[3 * p], hi[3 * p + 1], hi[3 * p + 2]};
    return b;
  }

  int32_t alloc() {
    node_min.insert(node_min.end(), {0, 0, 0});
    node_max.insert(node_max.end(), {0, 0, 0});
    left.push_back(0);
    right.push_back(0);
    is_leaf.push_back(0);
    return static_cast<int32_t>(left.size()) - 1;
  }
};

struct Task {
  int32_t node, start, end, depth;
};

// Exact-sweep threshold for row-granular builds: nodes this small get a
// full 3-axis sorted sweep (O(n log n)) instead of 16 bins, so splits can
// land exactly on row multiples.  Fill is decided at the bottom of the
// tree, which is exactly where bins are too coarse to see row boundaries.
constexpr int32_t kExactSweep = 64;

inline float caxis(const Vec3 &c, int ax) {
  return ax == 0 ? c.x : ax == 1 ? c.y : c.z;
}

// ``row`` > 0 prices children in LEAF ROWS (ceil(count/row)) instead of
// primitives.  A traversal whose leaf visit costs one fixed row of ``row``
// triangle tests regardless of how full the leaf is makes the
// per-primitive SAH overestimate the cost of full leaves and build
// under-filled ones (bunny mean fill 5.75/8 -> 12,680 leaves vs the 9,120
// minimum).  Row-granular costs make fuller leaves and fewer leaf visits.
void build(BuildState &st, int leaf_size, int row = 0) {
  auto rowsf = [row](int32_t c) {
    return row > 0 ? static_cast<float>((c + row - 1) / row)
                   : static_cast<float>(c);
  };
  std::vector<Task> stack;
  int32_t n = static_cast<int32_t>(st.order.size());
  int32_t root = st.alloc();
  stack.push_back({root, 0, n, 0});

  while (!stack.empty()) {
    Task t = stack.back();
    stack.pop_back();
    AABB box, cbox;
    for (int32_t i = t.start; i < t.end; ++i) {
      box.grow(st.prim_box(st.order[i]));
      cbox.grow(st.centroid[st.order[i]]);
    }
    st.node_min[3 * t.node] = box.lo.x;
    st.node_min[3 * t.node + 1] = box.lo.y;
    st.node_min[3 * t.node + 2] = box.lo.z;
    st.node_max[3 * t.node] = box.hi.x;
    st.node_max[3 * t.node + 1] = box.hi.y;
    st.node_max[3 * t.node + 2] = box.hi.z;

    int32_t count = t.end - t.start;
    auto make_leaf = [&]() {
      st.left[t.node] = t.start;
      st.right[t.node] = count;
      st.is_leaf[t.node] = 1;
    };
    if (count <= leaf_size || t.depth >= kMaxStack - 2) {
      make_leaf();
      continue;
    }

    if (row > 0 && count <= kExactSweep) {
      // Exact row-granular sweep: all three axes, every split position.
      int best_axis = -1;
      int32_t best_pos = -1;
      float best = std::numeric_limits<float>::infinity();
      std::vector<int32_t> idx(st.order.begin() + t.start,
                               st.order.begin() + t.end);
      std::vector<float> rarea(count);
      for (int ax = 0; ax < 3; ++ax) {
        std::sort(idx.begin(), idx.end(), [&](int32_t a, int32_t b) {
          return caxis(st.centroid[a], ax) < caxis(st.centroid[b], ax);
        });
        AABB acc;
        for (int32_t i = count - 1; i >= 1; --i) {
          acc.grow(st.prim_box(idx[i]));
          rarea[i] = acc.half_area();
        }
        acc = AABB();
        for (int32_t i = 0; i + 1 < count; ++i) {
          acc.grow(st.prim_box(idx[i]));
          float c = acc.half_area() * rowsf(i + 1) +
                    rarea[i + 1] * rowsf(count - i - 1);
          if (c < best) {
            best = c;
            best_axis = ax;
            best_pos = i + 1;
          }
        }
      }
      std::sort(st.order.begin() + t.start, st.order.begin() + t.end,
                [&](int32_t a, int32_t b) {
                  return caxis(st.centroid[a], best_axis) <
                         caxis(st.centroid[b], best_axis);
                });
      int32_t mid = t.start + best_pos;
      int32_t l = st.alloc(), r = st.alloc();
      st.left[t.node] = l;
      st.right[t.node] = r;
      st.is_leaf[t.node] = 0;
      stack.push_back({l, t.start, mid, t.depth + 1});
      stack.push_back({r, mid, t.end, t.depth + 1});
      continue;
    }

    // Binned SAH over the widest centroid axis.
    float ext[3] = {cbox.hi.x - cbox.lo.x, cbox.hi.y - cbox.lo.y,
                    cbox.hi.z - cbox.lo.z};
    int axis = 0;
    if (ext[1] > ext[0]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    float cmin = (axis == 0 ? cbox.lo.x : axis == 1 ? cbox.lo.y : cbox.lo.z);
    float cext = ext[axis];
    if (cext <= 1e-12f) {
      // Degenerate spread: median split keeps the tree balanced (the
      // forced-leaf guard of the reference's BVH v2 would make giant
      // leaves here; splitting is strictly better).
      int32_t mid = t.start + count / 2;
      std::nth_element(
          st.order.begin() + t.start, st.order.begin() + mid,
          st.order.begin() + t.end, [&](int32_t a, int32_t b) {
            float ca = (axis == 0   ? st.centroid[a].x
                        : axis == 1 ? st.centroid[a].y
                                    : st.centroid[a].z);
            float cb = (axis == 0   ? st.centroid[b].x
                        : axis == 1 ? st.centroid[b].y
                                    : st.centroid[b].z);
            return ca < cb;
          });
      int32_t l = st.alloc(), r = st.alloc();
      st.left[t.node] = l;
      st.right[t.node] = r;
      st.is_leaf[t.node] = 0;
      stack.push_back({l, t.start, mid, t.depth + 1});
      stack.push_back({r, mid, t.end, t.depth + 1});
      continue;
    }

    AABB bin_box[kBins];
    int32_t bin_count[kBins] = {0};
    float inv = kBins / cext;
    auto bin_of = [&](int32_t p) {
      float c = (axis == 0   ? st.centroid[p].x
                 : axis == 1 ? st.centroid[p].y
                             : st.centroid[p].z);
      int b = static_cast<int>((c - cmin) * inv);
      return std::min(std::max(b, 0), kBins - 1);
    };
    for (int32_t i = t.start; i < t.end; ++i) {
      int b = bin_of(st.order[i]);
      bin_box[b].grow(st.prim_box(st.order[i]));
      bin_count[b]++;
    }

    // Sweep: left-to-right and right-to-left prefix areas.
    float left_area[kBins - 1], right_area[kBins - 1];
    int32_t left_cnt[kBins - 1], right_cnt[kBins - 1];
    AABB acc;
    int32_t cacc = 0;
    for (int b = 0; b < kBins - 1; ++b) {
      acc.grow(bin_box[b]);
      cacc += bin_count[b];
      left_area[b] = acc.half_area();
      left_cnt[b] = cacc;
    }
    acc = AABB();
    cacc = 0;
    for (int b = kBins - 1; b >= 1; --b) {
      acc.grow(bin_box[b]);
      cacc += bin_count[b];
      right_area[b - 1] = acc.half_area();
      right_cnt[b - 1] = cacc;
    }

    int best_split = -1;
    float best_cost = std::numeric_limits<float>::infinity();
    for (int b = 0; b < kBins - 1; ++b) {
      if (left_cnt[b] == 0 || right_cnt[b] == 0) continue;
      float cost = left_area[b] * rowsf(left_cnt[b]) +
                   right_area[b] * rowsf(right_cnt[b]);
      if (cost < best_cost) {
        best_cost = cost;
        best_split = b;
      }
    }

    // SAH termination: splitting must beat the leaf cost.  Row mode never
    // early-terminates into an oversize leaf: max_leaf must stay at
    // leaf_size or rows_per_visit grows for EVERY leaf in the tree.
    float leaf_cost = box.half_area() * rowsf(count);
    if (best_split < 0 ||
        (row == 0 && count <= 2 * leaf_size && best_cost >= leaf_cost)) {
      if (row == 0 && count <= 4 * leaf_size) {
        make_leaf();
        continue;
      }
      best_split = kBins / 2 - 1;  // fall back to a mid split
    }

    auto mid_it = std::partition(
        st.order.begin() + t.start, st.order.begin() + t.end,
        [&](int32_t p) { return bin_of(p) <= best_split; });
    int32_t mid = static_cast<int32_t>(mid_it - st.order.begin());
    if (mid == t.start || mid == t.end) {
      // partition failed to separate (numeric edge): median split
      mid = t.start + count / 2;
      std::nth_element(st.order.begin() + t.start, st.order.begin() + mid,
                       st.order.begin() + t.end, [&](int32_t a, int32_t b) {
                         return (axis == 0   ? st.centroid[a].x
                                 : axis == 1 ? st.centroid[a].y
                                             : st.centroid[a].z) <
                                (axis == 0   ? st.centroid[b].x
                                 : axis == 1 ? st.centroid[b].y
                                             : st.centroid[b].z);
                       });
    }
    int32_t l = st.alloc(), r = st.alloc();
    st.left[t.node] = l;
    st.right[t.node] = r;
    st.is_leaf[t.node] = 0;
    stack.push_back({l, t.start, mid, t.depth + 1});
    stack.push_back({r, mid, t.end, t.depth + 1});
  }
}

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on error.  Callers allocate
// out_* for the worst case of 2n-1 nodes (n >= 1).
//   lo, hi:        (n, 3) float32 primitive AABBs
//   out_node_min:  (2n-1, 3) float32
//   out_node_max:  (2n-1, 3) float32
//   out_left/right/is_leaf: (2n-1,) int32
//   out_prim_idx:  (n,) int32 — leaf-contiguous primitive permutation
int32_t spira_build_bvh_rows(const float *lo, const float *hi, int32_t n,
                             int32_t leaf_size, int32_t row,
                             float *out_node_min, float *out_node_max,
                             int32_t *out_left, int32_t *out_right,
                             int32_t *out_is_leaf, int32_t *out_prim_idx) {
  if (n <= 0 || leaf_size <= 0 || row < 0) return -1;
  BuildState st;
  st.lo = lo;
  st.hi = hi;
  st.centroid.resize(n);
  st.order.resize(n);
  for (int32_t i = 0; i < n; ++i) {
    st.centroid[i] = {0.5f * (lo[3 * i] + hi[3 * i]),
                      0.5f * (lo[3 * i + 1] + hi[3 * i + 1]),
                      0.5f * (lo[3 * i + 2] + hi[3 * i + 2])};
    st.order[i] = i;
  }
  build(st, leaf_size, row);
  int32_t m = static_cast<int32_t>(st.left.size());
  if (m > 2 * n - 1 && n > 1) return -1;  // contract violation
  std::memcpy(out_node_min, st.node_min.data(), sizeof(float) * 3 * m);
  std::memcpy(out_node_max, st.node_max.data(), sizeof(float) * 3 * m);
  std::memcpy(out_left, st.left.data(), sizeof(int32_t) * m);
  std::memcpy(out_right, st.right.data(), sizeof(int32_t) * m);
  std::memcpy(out_is_leaf, st.is_leaf.data(), sizeof(int32_t) * m);
  std::memcpy(out_prim_idx, st.order.data(), sizeof(int32_t) * n);
  return m;
}

int32_t spira_build_bvh(const float *lo, const float *hi, int32_t n,
                        int32_t leaf_size, float *out_node_min,
                        float *out_node_max, int32_t *out_left,
                        int32_t *out_right, int32_t *out_is_leaf,
                        int32_t *out_prim_idx) {
  return spira_build_bvh_rows(lo, hi, n, leaf_size, /*row=*/0, out_node_min,
                              out_node_max, out_left, out_right, out_is_leaf,
                              out_prim_idx);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// SBVH: binned SAH with spatial splits (Stich, Friedrich & Dammertz, HPG
// 2009), reference-duplicating.  Motivation (round-5 counters): leaf visits
// are 77% of packet-traversal time and node overlap is what makes a packet
// visit leaves it cannot hit — spatial splits trade duplicated references
// for disjoint child boxes.  Triangles straddling the chosen plane are
// clipped (true polygon clip when vertices are provided, box-clamp
// otherwise) and referenced in BOTH children.  Leaves may therefore contain
// duplicate primitive ids; every consumer (leaf packing, traversal, the
// NumPy oracle) already tolerates that — re-testing a triangle is
// idempotent for closest-hit.
// ---------------------------------------------------------------------------

namespace {

struct Ref {
  int32_t prim;
  AABB box;
};

struct SBuild {
  const float *va, *vb, *vc;  // (n,3) vertices or nullptr
  int leaf_size;
  float alpha_area;  // spatial splits allowed when child overlap > this
  int32_t max_refs;
  int32_t emitted = 0;
  std::vector<float> node_min, node_max;
  std::vector<int32_t> left, right, is_leaf;
  std::vector<int32_t> prim_out;

  int32_t alloc() {
    node_min.insert(node_min.end(), {0, 0, 0});
    node_max.insert(node_max.end(), {0, 0, 0});
    left.push_back(0);
    right.push_back(0);
    is_leaf.push_back(0);
    return static_cast<int32_t>(left.size()) - 1;
  }
};

inline float axval(const Vec3 &v, int axis) {
  return axis == 0 ? v.x : axis == 1 ? v.y : v.z;
}

// AABB of the triangle polygon clipped to slab [plane_lo, plane_hi] on
// `axis`, intersected with `refbox` (which carries previous clips).
AABB clip_tri(const SBuild &st, int32_t prim, const AABB &refbox, int axis,
              float plane_lo, float plane_hi) {
  AABB out;
  if (st.va == nullptr) {
    out = refbox;  // box clamp only
  } else {
    Vec3 poly[8], next[8];
    poly[0] = {st.va[3 * prim], st.va[3 * prim + 1], st.va[3 * prim + 2]};
    poly[1] = {st.vb[3 * prim], st.vb[3 * prim + 1], st.vb[3 * prim + 2]};
    poly[2] = {st.vc[3 * prim], st.vc[3 * prim + 1], st.vc[3 * prim + 2]};
    int cnt = 3;
    // Sutherland–Hodgman against the two slab planes
    for (int side = 0; side < 2; ++side) {
      float plane = side == 0 ? plane_lo : plane_hi;
      float sign = side == 0 ? 1.0f : -1.0f;  // keep sign*(x-plane) >= 0
      int ncnt = 0;
      for (int i = 0; i < cnt; ++i) {
        const Vec3 &a = poly[i];
        const Vec3 &b = poly[(i + 1) % cnt];
        float da = sign * (axval(a, axis) - plane);
        float db = sign * (axval(b, axis) - plane);
        if (da >= 0.0f) next[ncnt++] = a;
        if ((da >= 0.0f) != (db >= 0.0f)) {
          float t = da / (da - db);
          next[ncnt++] = {a.x + t * (b.x - a.x), a.y + t * (b.y - a.y),
                          a.z + t * (b.z - a.z)};
        }
      }
      cnt = ncnt;
      for (int i = 0; i < cnt; ++i) poly[i] = next[i];
      if (cnt == 0) break;
    }
    if (cnt == 0) {
      out = refbox;  // numeric edge: fall back to the box clamp
    } else {
      for (int i = 0; i < cnt; ++i) out.grow(poly[i]);
    }
  }
  // clamp to the slab and to the incoming reference box
  out.lo = vmax(out.lo, refbox.lo);
  out.hi = vmin(out.hi, refbox.hi);
  if (axis == 0) {
    out.lo.x = std::max(out.lo.x, plane_lo);
    out.hi.x = std::min(out.hi.x, plane_hi);
  } else if (axis == 1) {
    out.lo.y = std::max(out.lo.y, plane_lo);
    out.hi.y = std::min(out.hi.y, plane_hi);
  } else {
    out.lo.z = std::max(out.lo.z, plane_lo);
    out.hi.z = std::min(out.hi.z, plane_hi);
  }
  out.lo = vmin(out.lo, out.hi);  // keep a valid (possibly flat) box
  return out;
}

void sbuild(SBuild &st, std::vector<Ref> &refs, int32_t node, int depth) {
  AABB box, cbox;
  for (const Ref &r : refs) {
    box.grow(r.box);
    cbox.grow(Vec3{0.5f * (r.box.lo.x + r.box.hi.x),
                   0.5f * (r.box.lo.y + r.box.hi.y),
                   0.5f * (r.box.lo.z + r.box.hi.z)});
  }
  st.node_min[3 * node] = box.lo.x;
  st.node_min[3 * node + 1] = box.lo.y;
  st.node_min[3 * node + 2] = box.lo.z;
  st.node_max[3 * node] = box.hi.x;
  st.node_max[3 * node + 1] = box.hi.y;
  st.node_max[3 * node + 2] = box.hi.z;

  int32_t count = static_cast<int32_t>(refs.size());
  auto make_leaf = [&]() {
    st.left[node] = st.emitted;
    st.right[node] = count;
    st.is_leaf[node] = 1;
    for (const Ref &r : refs) st.prim_out.push_back(r.prim);
    st.emitted += count;
  };
  if (count <= st.leaf_size || depth >= kMaxStack - 2) {
    make_leaf();
    return;
  }

  // ---- object split: binned SAH over the widest centroid axis
  float ext[3] = {cbox.hi.x - cbox.lo.x, cbox.hi.y - cbox.lo.y,
                  cbox.hi.z - cbox.lo.z};
  int oaxis = 0;
  if (ext[1] > ext[0]) oaxis = 1;
  if (ext[2] > ext[oaxis]) oaxis = 2;
  float cmin = axval(cbox.lo, oaxis);
  float cext = ext[oaxis];

  float obj_cost = std::numeric_limits<float>::infinity();
  int obj_split = -1;
  AABB obj_lbox, obj_rbox;
  auto obj_bin = [&](const Ref &r) {
    float c = 0.5f * (axval(r.box.lo, oaxis) + axval(r.box.hi, oaxis));
    int b = static_cast<int>((c - cmin) * (kBins / cext));
    return std::min(std::max(b, 0), kBins - 1);
  };
  if (cext > 1e-12f) {
    AABB bb[kBins];
    int32_t bc[kBins] = {0};
    for (const Ref &r : refs) {
      int b = obj_bin(r);
      bb[b].grow(r.box);
      bc[b]++;
    }
    AABB lacc[kBins];
    int32_t lcnt[kBins] = {0};
    AABB acc;
    int32_t cacc = 0;
    for (int b = 0; b < kBins - 1; ++b) {
      acc.grow(bb[b]);
      cacc += bc[b];
      lacc[b] = acc;
      lcnt[b] = cacc;
    }
    acc = AABB();
    cacc = 0;
    for (int b = kBins - 1; b >= 1; --b) {
      acc.grow(bb[b]);
      cacc += bc[b];
      if (lcnt[b - 1] == 0 || cacc == 0) continue;
      float cost = lacc[b - 1].half_area() * lcnt[b - 1] +
                   acc.half_area() * cacc;
      if (cost < obj_cost) {
        obj_cost = cost;
        obj_split = b - 1;
        obj_lbox = lacc[b - 1];
        obj_rbox = acc;
      }
    }
  }

  // ---- spatial split: considered when the object children overlap
  // enough (SBVH alpha test) or no object split exists
  float sp_cost = std::numeric_limits<float>::infinity();
  int sp_axis = -1;
  float sp_plane = 0.0f;
  bool refs_left = st.emitted + 2 * count < st.max_refs;
  AABB ov;
  bool try_spatial = refs_left;
  if (obj_split >= 0 && try_spatial) {
    ov.lo = vmax(obj_lbox.lo, obj_rbox.lo);
    ov.hi = vmin(obj_lbox.hi, obj_rbox.hi);
    bool overlaps = ov.lo.x <= ov.hi.x && ov.lo.y <= ov.hi.y &&
                    ov.lo.z <= ov.hi.z;
    try_spatial = overlaps && ov.half_area() > st.alpha_area;
  }
  if (try_spatial) {
    for (int axis = 0; axis < 3; ++axis) {
      float nlo = axval(box.lo, axis), nhi = axval(box.hi, axis);
      float next_ = nhi - nlo;
      if (next_ <= 1e-12f) continue;
      AABB bb[kBins];
      int32_t enter[kBins] = {0}, exit_[kBins] = {0};
      float inv = kBins / next_;
      for (const Ref &r : refs) {
        int b0 = static_cast<int>((axval(r.box.lo, axis) - nlo) * inv);
        int b1 = static_cast<int>((axval(r.box.hi, axis) - nlo) * inv);
        b0 = std::min(std::max(b0, 0), kBins - 1);
        b1 = std::min(std::max(b1, 0), kBins - 1);
        enter[b0]++;
        exit_[b1]++;
        if (b0 == b1) {
          bb[b0].grow(r.box);
        } else {
          for (int b = b0; b <= b1; ++b) {
            bb[b].grow(clip_tri(st, r.prim, r.box, axis,
                                nlo + b / inv, nlo + (b + 1) / inv));
          }
        }
      }
      AABB lacc[kBins];
      int32_t lcnt[kBins] = {0};
      AABB acc;
      int32_t cacc = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        acc.grow(bb[b]);
        cacc += enter[b];
        lacc[b] = acc;
        lcnt[b] = cacc;
      }
      acc = AABB();
      cacc = 0;
      for (int b = kBins - 1; b >= 1; --b) {
        acc.grow(bb[b]);
        cacc += exit_[b];
        if (lcnt[b - 1] == 0 || cacc == 0) continue;
        float cost = lacc[b - 1].half_area() * lcnt[b - 1] +
                     acc.half_area() * cacc;
        if (cost < sp_cost) {
          sp_cost = cost;
          sp_axis = axis;
          sp_plane = nlo + b / inv;
        }
      }
    }
  }

  if (obj_split < 0 && sp_axis < 0) {
    // no split available (degenerate spread): median split on prim id
    // order to keep leaves bounded
    if (count <= 4 * st.leaf_size) {
      make_leaf();
      return;
    }
    std::vector<Ref> lrefs(refs.begin(), refs.begin() + count / 2);
    std::vector<Ref> rrefs(refs.begin() + count / 2, refs.end());
    refs.clear();
    refs.shrink_to_fit();
    int32_t l = st.alloc(), r = st.alloc();
    st.left[node] = l;
    st.right[node] = r;
    sbuild(st, lrefs, l, depth + 1);
    sbuild(st, rrefs, r, depth + 1);
    return;
  }

  std::vector<Ref> lrefs, rrefs;
  if (sp_axis >= 0 && sp_cost < obj_cost) {
    // spatial split: straddlers are clipped into both children
    for (const Ref &r : refs) {
      float blo = axval(r.box.lo, sp_axis), bhi = axval(r.box.hi, sp_axis);
      if (bhi <= sp_plane) {
        lrefs.push_back(r);
      } else if (blo >= sp_plane) {
        rrefs.push_back(r);
      } else if (st.emitted + static_cast<int32_t>(
                     lrefs.size() + rrefs.size()) + 2 < st.max_refs) {
        Ref lr = r, rr = r;
        lr.box = clip_tri(st, r.prim, r.box, sp_axis,
                          -std::numeric_limits<float>::infinity(), sp_plane);
        rr.box = clip_tri(st, r.prim, r.box, sp_axis, sp_plane,
                          std::numeric_limits<float>::infinity());
        lrefs.push_back(lr);
        rrefs.push_back(rr);
      } else {
        // reference budget exhausted: unsplit to the larger-overlap side
        (sp_plane - blo >= bhi - sp_plane ? lrefs : rrefs).push_back(r);
      }
    }
    if (lrefs.empty() || rrefs.empty()) {
      make_leaf();  // numeric edge; count is bounded by the budget anyway
      return;
    }
  } else {
    for (const Ref &r : refs) {
      (obj_bin(r) <= obj_split ? lrefs : rrefs).push_back(r);
    }
    if (lrefs.empty() || rrefs.empty()) {
      size_t mid = refs.size() / 2;
      lrefs.assign(refs.begin(), refs.begin() + mid);
      rrefs.assign(refs.begin() + mid, refs.end());
    }
  }
  refs.clear();
  refs.shrink_to_fit();
  int32_t l = st.alloc(), r = st.alloc();
  st.left[node] = l;
  st.right[node] = r;
  sbuild(st, lrefs, l, depth + 1);
  sbuild(st, rrefs, r, depth + 1);
}

}  // namespace

extern "C" {

// SBVH build.  va/vb/vc may be nullptr (box-clamp clipping).  Outputs are
// caller-allocated for max_refs references: nodes (2*max_refs-1, ...),
// prim_idx (max_refs,).  Writes the reference count to *out_n_refs and
// returns the node count, or -1 on error.  Leaves index prim_idx, which
// may contain duplicated primitive ids (spatial splits).
int32_t spira_build_sbvh(const float *lo, const float *hi, const float *va,
                         const float *vb, const float *vc, int32_t n,
                         int32_t leaf_size, float alpha, int32_t max_refs,
                         float *out_node_min, float *out_node_max,
                         int32_t *out_left, int32_t *out_right,
                         int32_t *out_is_leaf, int32_t *out_prim_idx,
                         int32_t *out_n_refs) {
  if (n <= 0 || leaf_size <= 0 || max_refs < n) return -1;
  SBuild st;
  st.va = va;
  st.vb = vb;
  st.vc = vc;
  st.leaf_size = leaf_size;
  st.max_refs = max_refs;
  std::vector<Ref> refs(n);
  AABB root;
  for (int32_t i = 0; i < n; ++i) {
    refs[i].prim = i;
    refs[i].box.lo = {lo[3 * i], lo[3 * i + 1], lo[3 * i + 2]};
    refs[i].box.hi = {hi[3 * i], hi[3 * i + 1], hi[3 * i + 2]};
    root.grow(refs[i].box);
  }
  st.alpha_area = alpha * root.half_area();
  int32_t rootn = st.alloc();
  sbuild(st, refs, rootn, 0);
  int32_t m = static_cast<int32_t>(st.left.size());
  if (m > 2 * max_refs - 1) return -1;
  if (st.emitted > max_refs) return -1;
  std::memcpy(out_node_min, st.node_min.data(), sizeof(float) * 3 * m);
  std::memcpy(out_node_max, st.node_max.data(), sizeof(float) * 3 * m);
  std::memcpy(out_left, st.left.data(), sizeof(int32_t) * m);
  std::memcpy(out_right, st.right.data(), sizeof(int32_t) * m);
  std::memcpy(out_is_leaf, st.is_leaf.data(), sizeof(int32_t) * m);
  std::memcpy(out_prim_idx, st.prim_out.data(),
              sizeof(int32_t) * st.emitted);
  *out_n_refs = st.emitted;
  return m;
}

}  // extern "C"
