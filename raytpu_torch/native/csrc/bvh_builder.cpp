// Native BVH builder for raytpu.
//
// The reference delegates acceleration-structure builds to the GPU driver
// (wgpu build_acceleration_structures, src/state.rs:1241) and asks for a
// QUALITY tree (PREFER_FAST_TRACE, src/state.rs:1170-1176); raytpu owns
// the structure in software, and this C++ builder is the production path
// for the host-side build (the Python builder in accel/bvh.py stays as
// the readable fallback/reference — object splits only, ~100x slower).
//
// Algorithm:
//   * top-down binned SAH (16 bins) over *references* (triangle + box);
//   * SBVH spatial splits (Stich et al. 2009): when the best object
//     split's children overlap significantly, a binned spatial split on
//     the node's largest axis competes on SAH cost. Straddling
//     references are clipped (Sutherland–Hodgman against the plane,
//     intersected with the parent fragment's box) and may be emitted to
//     BOTH sides, bounded by a global duplication budget (0.4n).
//     Duplicated references carry bit-identical triangle data, so the
//     engine's lowest-slot tie break keeps every traversal path
//     bit-agreeing (kernels/strand.py, kernels/intersect_pallas.py);
//   * median split when centroids degenerate or beyond depth 32 (bounds
//     tree depth, hence the device traversal stack);
//   * leaves hold up to LEAF_SIZE references (same-triangle fragments
//     deduped within a leaf), assigned leaf rows in DFS order (the
//     shared triangle order for both device layouts);
//   * emission one: threaded (skip-link) binary layout in DFS pre-order;
//   * emission two: 8-wide collapse (expand the largest-area interior
//     cluster root until 8 slots), children packed per 128-lane row.
//
// C ABI only (loaded with ctypes): raytpu_bvh_build fills
// caller-allocated worst-case buffers and reports actual sizes. With
// m = n + floor(0.4 n) + 8 (the reference cap), the caller must provide
// cap_nodes >= 2m+1, cap_wide >= m+1, cap_order >= m + (m+1)*leaf_size.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

constexpr int N_BINS = 16;
constexpr int MAX_SAH_DEPTH = 32;
constexpr int BVH8_WIDTH = 8;
// spatial splits compete only when the object split's children overlap
// by more than this fraction of the root surface area (Stich's alpha)
constexpr float SBVH_ALPHA = 1e-5f;

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float get(const V3 &v, int axis) {
  return axis == 0 ? v.x : axis == 1 ? v.y : v.z;
}

struct Box {
  V3 lo{3.4e38f, 3.4e38f, 3.4e38f};
  V3 hi{-3.4e38f, -3.4e38f, -3.4e38f};
  void grow(const V3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  void grow(const Box &b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  bool valid() const { return lo.x <= hi.x && lo.y <= hi.y && lo.z <= hi.z; }
  Box intersect(const Box &b) const {
    return {vmax(lo, b.lo), vmin(hi, b.hi)};
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.0f);
    float dy = std::max(hi.y - lo.y, 0.0f);
    float dz = std::max(hi.z - lo.z, 0.0f);
    return dx * dy + dy * dz + dz * dx;
  }
  V3 center() const {
    return {(lo.x + hi.x) * 0.5f, (lo.y + hi.y) * 0.5f,
            (lo.z + hi.z) * 0.5f};
  }
};

struct Ref {
  int tri;
  Box box;  // clipped fragment bounds (whole-triangle box for roots)
};

struct Rec {
  Box box;
  int left = -1;   // record index, -1 for leaf
  int right = -1;  // record index
  int first = -1;  // leaf: first index into leaf_ids
  int count = 0;   // leaf: reference count (post-dedupe)
};

struct Builder {
  const float *p0, *e1, *e2;
  int n;
  int leaf_size;
  int spare;  // remaining reference-duplication budget
  std::vector<Rec> recs;
  std::vector<int> leaf_ids;  // leaf-contiguous tri ids (dedupe applied)
  float root_area = 0.0f;

  V3 vert(int tri, int k) const {
    V3 a{p0[3 * tri], p0[3 * tri + 1], p0[3 * tri + 2]};
    if (k == 0) return a;
    const float *e = k == 1 ? e1 : e2;
    return {a.x + e[3 * tri], a.y + e[3 * tri + 1], a.z + e[3 * tri + 2]};
  }

  // box of the triangle clipped to the half-space (axis <= plane when
  // keep_lo, else axis >= plane), intersected with the fragment's box
  Box clip_half(int tri, int axis, float plane, bool keep_lo,
                const Box &frag) const {
    V3 poly[8];
    int np = 3;
    poly[0] = vert(tri, 0);
    poly[1] = vert(tri, 1);
    poly[2] = vert(tri, 2);
    V3 out[8];
    int no = 0;
    for (int i = 0; i < np; ++i) {
      V3 a = poly[i], b = poly[(i + 1) % np];
      float da = get(a, axis) - plane, db = get(b, axis) - plane;
      bool ina = keep_lo ? da <= 0.0f : da >= 0.0f;
      bool inb = keep_lo ? db <= 0.0f : db >= 0.0f;
      if (ina) out[no++] = a;
      if (ina != inb) {
        float t = da / (da - db);
        out[no++] = {a.x + t * (b.x - a.x), a.y + t * (b.y - a.y),
                     a.z + t * (b.z - a.z)};
      }
    }
    Box b;
    for (int i = 0; i < no; ++i) b.grow(out[i]);
    return b.intersect(frag);
  }

  int build(std::vector<Ref> refs, int depth) {
    Box box;
    for (const Ref &r : refs) box.grow(r.box);
    if (depth == 0) root_area = box.area();

    int rec = (int)recs.size();
    recs.push_back({});
    recs[rec].box = box;

    int count = (int)refs.size();
    std::vector<Ref> lt, rt;
    bool split_done = false;
    if (count > leaf_size && depth < MAX_SAH_DEPTH) {
      split_done = sah_split(refs, box, lt, rt);
    }
    if (!split_done && count > leaf_size) {
      // median fallback (order preserved; also the beyond-depth route)
      int half = count / 2;
      lt.assign(refs.begin(), refs.begin() + half);
      rt.assign(refs.begin() + half, refs.end());
      split_done = true;
    }
    if (!split_done) {
      // leaf: dedupe fragments of the same triangle (spatial splits can
      // land both halves here); keep first-seen order for determinism
      int first = (int)leaf_ids.size();
      int kept = 0;
      for (const Ref &r : refs) {
        bool dup = false;
        for (int i = 0; i < kept; ++i)
          if (leaf_ids[first + i] == r.tri) {
            dup = true;
            break;
          }
        if (!dup) leaf_ids.push_back(r.tri), ++kept;
      }
      recs[rec].first = first;
      recs[rec].count = kept;
      return rec;
    }
    refs.clear();
    refs.shrink_to_fit();
    int l = build(std::move(lt), depth + 1);
    int r = build(std::move(rt), depth + 1);
    recs[rec].left = l;
    recs[rec].right = r;
    return rec;
  }

  // best binned object split; returns (cost, axis, plane-bin, overlap
  // area of the two child boxes) with cost = inf when none found
  struct ObjSplit {
    float cost = 3.4e38f;
    int axis = -1;
    float base = 0, scale = 0;
    int bin = -1;
    float overlap = 0;
  };

  ObjSplit object_split(const std::vector<Ref> &refs) const {
    ObjSplit best;
    V3 cmin{3.4e38f, 3.4e38f, 3.4e38f}, cmax{-3.4e38f, -3.4e38f, -3.4e38f};
    for (const Ref &r : refs) {
      V3 c = r.box.center();
      cmin = vmin(cmin, c);
      cmax = vmax(cmax, c);
    }
    int count = (int)refs.size();
    for (int axis = 0; axis < 3; ++axis) {
      float ext = get(cmax, axis) - get(cmin, axis);
      if (ext <= 0.0f) continue;
      float base = get(cmin, axis);
      float scale = N_BINS * (1.0f - 1e-6f) / ext;
      int counts[N_BINS] = {0};
      Box bins[N_BINS];
      for (const Ref &r : refs) {
        int b = std::min((int)((get(r.box.center(), axis) - base) * scale),
                         N_BINS - 1);
        counts[b]++;
        bins[b].grow(r.box);
      }
      float larea[N_BINS];
      int lcount[N_BINS];
      Box lbox[N_BINS];
      Box acc;
      int cnt = 0;
      for (int b = 0; b < N_BINS; ++b) {
        acc.grow(bins[b]);
        cnt += counts[b];
        larea[b] = acc.area();
        lcount[b] = cnt;
        lbox[b] = acc;
      }
      Box racc;
      Box rbox[N_BINS];
      float rarea[N_BINS];
      for (int b = N_BINS - 1; b >= 0; --b) {
        racc.grow(bins[b]);
        rarea[b] = racc.area();
        rbox[b] = racc;
      }
      for (int b = 0; b < N_BINS - 1; ++b) {
        int lc = lcount[b], rc = count - lc;
        if (lc == 0 || rc == 0) continue;
        float cost = larea[b] * lc + rarea[b + 1] * rc;
        if (cost < best.cost) {
          best = {cost, axis, base, scale, b,
                  lbox[b].intersect(rbox[b + 1]).valid()
                      ? lbox[b].intersect(rbox[b + 1]).area()
                      : 0.0f};
        }
      }
    }
    return best;
  }

  // partitions refs into lt/rt; returns true when a split was applied
  bool sah_split(const std::vector<Ref> &refs, const Box &node_box,
                 std::vector<Ref> &lt, std::vector<Ref> &rt) {
    ObjSplit obj = object_split(refs);

    // --- spatial split candidate (largest node-box axis) ---
    float best_sp_cost = 3.4e38f;
    int sp_axis = -1;
    float sp_plane = 0;
    {
      float ext[3] = {node_box.hi.x - node_box.lo.x,
                      node_box.hi.y - node_box.lo.y,
                      node_box.hi.z - node_box.lo.z};
      int axis = ext[1] > ext[0] ? (ext[2] > ext[1] ? 2 : 1)
                                 : (ext[2] > ext[0] ? 2 : 0);
      bool consider = spare > 0 && ext[axis] > 0.0f &&
                      obj.overlap > SBVH_ALPHA * root_area;
      if (consider) {
        float lo = get(node_box.lo, axis);
        float scale = N_BINS / ext[axis];
        int entry[N_BINS] = {0}, exit_[N_BINS] = {0};
        Box bins[N_BINS];
        for (const Ref &r : refs) {
          int b0 = std::clamp((int)((get(r.box.lo, axis) - lo) * scale), 0,
                              N_BINS - 1);
          int b1 = std::clamp((int)((get(r.box.hi, axis) - lo) * scale), 0,
                              N_BINS - 1);
          entry[b0]++;
          exit_[b1]++;
          if (b0 == b1) {
            bins[b0].grow(r.box);
          } else {
            // tight per-bin bounds: clip the triangle to each bin slab
            for (int b = b0; b <= b1; ++b) {
              float p_lo = lo + b / (float)N_BINS * ext[axis];
              float p_hi = lo + (b + 1) / (float)N_BINS * ext[axis];
              Box c = clip_half(r.tri, axis, p_hi, true, r.box);
              if (b > b0) {
                // also clip away the part below the bin's lower plane
                Box c2 = clip_half(r.tri, axis, p_lo, false, r.box);
                c = c.intersect(c2);
              }
              if (c.valid()) bins[b].grow(c);
            }
          }
        }
        float larea[N_BINS], rarea[N_BINS];
        int lcount[N_BINS], rcount[N_BINS];
        Box acc;
        int cnt = 0;
        for (int b = 0; b < N_BINS; ++b) {
          acc.grow(bins[b]);
          cnt += entry[b];
          larea[b] = acc.area();
          lcount[b] = cnt;
        }
        Box racc;
        cnt = 0;
        for (int b = N_BINS - 1; b >= 0; --b) {
          racc.grow(bins[b]);
          cnt += exit_[b];
          rarea[b] = racc.area();
          rcount[b] = cnt;
        }
        for (int b = 0; b < N_BINS - 1; ++b) {
          int lc = lcount[b], rc = rcount[b + 1];
          if (lc == 0 || rc == 0) continue;
          float cost = larea[b] * lc + rarea[b + 1] * rc;
          if (cost < best_sp_cost) {
            best_sp_cost = cost;
            sp_axis = axis;
            sp_plane = lo + (b + 1) / (float)N_BINS * ext[axis];
          }
        }
      }
    }

    if (sp_axis >= 0 && best_sp_cost < obj.cost) {
      // --- apply the spatial split ---
      int count = (int)refs.size();
      for (const Ref &r : refs) {
        if (get(r.box.hi, sp_axis) <= sp_plane) {
          lt.push_back(r);
        } else if (get(r.box.lo, sp_axis) >= sp_plane) {
          rt.push_back(r);
        } else {
          Box lb = clip_half(r.tri, sp_axis, sp_plane, true, r.box);
          Box rb = clip_half(r.tri, sp_axis, sp_plane, false, r.box);
          if (lb.valid() && rb.valid() && spare > 0) {
            lt.push_back({r.tri, lb});
            rt.push_back({r.tri, rb});
            --spare;
          } else if (lb.valid() && !rb.valid()) {
            lt.push_back({r.tri, lb});
          } else if (rb.valid() && !lb.valid()) {
            rt.push_back({r.tri, rb});
          } else {
            // budget exhausted (or degenerate): whole fragment to the
            // side holding more of its extent
            float mid = (get(r.box.lo, sp_axis) + get(r.box.hi, sp_axis)) *
                        0.5f;
            (mid <= sp_plane ? lt : rt).push_back(r);
          }
        }
      }
      (void)count;
      if (!lt.empty() && !rt.empty()) return true;
      lt.clear();
      rt.clear();
    }

    if (obj.axis < 0) return false;
    // --- apply the object split (stable partition) ---
    for (const Ref &r : refs) {
      int b = std::min(
          (int)((get(r.box.center(), obj.axis) - obj.base) * obj.scale),
          N_BINS - 1);
      (b <= obj.bin ? lt : rt).push_back(r);
    }
    return !lt.empty() && !rt.empty();
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. Caller allocates (m = n + n*2/5 + 8):
//   nodes8      [cap_nodes * 8]  f32  (threaded rows: bmin, bmax, miss,
//                                      leaf_row bitcast int32)
//   node8_rows  [cap_wide * 128] f32  (8-wide rows)
//   tri_order   [cap_order]      i32  (-1 padding; SBVH may repeat ids)
// with cap_nodes >= 2*m+1, cap_wide >= m+1, cap_order >= m +
// (m+1)*leaf_size. out_counts = {n_nodes, n_wide, order_len}.
int raytpu_bvh_build(const float *p0, const float *e1, const float *e2,
                     int n, int leaf_size, float *nodes8, float *node8_rows,
                     int32_t *tri_order, int32_t *out_counts) {
  Builder B;
  B.p0 = p0;
  B.e1 = e1;
  B.e2 = e2;
  B.n = n;
  B.leaf_size = leaf_size;
  B.spare = n * 2 / 5 + 8;
  std::vector<Ref> roots(n);
  for (int i = 0; i < n; ++i) {
    Box bb;
    bb.grow(B.vert(i, 0));
    bb.grow(B.vert(i, 1));
    bb.grow(B.vert(i, 2));
    roots[i] = {i, bb};
  }
  B.recs.reserve(2 * n + 1);
  B.leaf_ids.reserve(n + B.spare);
  int root = B.build(std::move(roots), 0);

  // --- leaf rows in DFS order (shared triangle order) ---
  int n_recs = (int)B.recs.size();
  std::vector<int> leaf_row(n_recs, -1);
  int order_len = 0;
  {
    std::vector<int> stack{root};
    while (!stack.empty()) {
      int r = stack.back();
      stack.pop_back();
      const Rec &rec = B.recs[r];
      if (rec.left >= 0) {
        stack.push_back(rec.right);
        stack.push_back(rec.left);
      } else {
        leaf_row[r] = order_len / leaf_size;
        for (int i = 0; i < rec.count; ++i)
          tri_order[order_len + i] = B.leaf_ids[rec.first + i];
        int pad = (leaf_size - rec.count % leaf_size) % leaf_size;
        for (int i = 0; i < pad; ++i) tri_order[order_len + rec.count + i] = -1;
        order_len += rec.count + pad;
      }
    }
  }

  // --- threaded layout (DFS pre-order with miss links) ---
  int n_nodes = 0;
  {
    std::vector<int> flat_of(n_recs, -1);
    // (rec, miss_rec)
    std::vector<std::pair<int, int>> stack{{root, -1}}, emitted;
    emitted.reserve(n_recs);
    while (!stack.empty()) {
      auto [r, miss] = stack.back();
      stack.pop_back();
      flat_of[r] = (int)emitted.size();
      emitted.push_back({r, miss});
      const Rec &rec = B.recs[r];
      if (rec.left >= 0) {
        stack.push_back({rec.right, miss});
        stack.push_back({rec.left, rec.right});
      }
    }
    n_nodes = (int)emitted.size();
    for (int i = 0; i < n_nodes; ++i) {
      auto [r, miss] = emitted[i];
      const Rec &rec = B.recs[r];
      float *row = nodes8 + 8 * i;
      row[0] = rec.box.lo.x;
      row[1] = rec.box.lo.y;
      row[2] = rec.box.lo.z;
      row[3] = rec.box.hi.x;
      row[4] = rec.box.hi.y;
      row[5] = rec.box.hi.z;
      int32_t m = miss < 0 ? -1 : flat_of[miss];
      int32_t lr = rec.left >= 0 ? -1 : leaf_row[r];
      std::memcpy(row + 6, &m, 4);
      std::memcpy(row + 7, &lr, 4);
    }
  }

  // --- 8-wide collapse ---
  int n_wide = 0;
  {
    auto children_of = [&](int rec) {
      std::vector<int> slots;
      const Rec &r = B.recs[rec];
      if (r.left < 0) {
        slots.push_back(rec);
        return slots;
      }
      slots = {r.left, r.right};
      while ((int)slots.size() < BVH8_WIDTH) {
        int best = -1;
        float best_a = -1.0f;
        for (int i = 0; i < (int)slots.size(); ++i) {
          const Rec &s = B.recs[slots[i]];
          if (s.left >= 0 && s.box.area() > best_a) {
            best_a = s.box.area();
            best = i;
          }
        }
        if (best < 0) break;
        int s = slots[best];
        slots.erase(slots.begin() + best);
        slots.push_back(B.recs[s].left);
        slots.push_back(B.recs[s].right);
      }
      return slots;
    };

    std::vector<int> order{root};
    std::vector<int> wide_index(n_recs, -1);
    wide_index[root] = 0;
    std::vector<std::vector<int>> node_children;
    for (size_t qi = 0; qi < order.size(); ++qi) {
      auto slots = children_of(order[qi]);
      for (int s : slots) {
        if (B.recs[s].left >= 0) {
          wide_index[s] = (int)order.size();
          order.push_back(s);
        }
      }
      node_children.push_back(std::move(slots));
    }
    n_wide = (int)order.size();
    for (int ni = 0; ni < n_wide; ++ni) {
      float *row = node8_rows + 128 * ni;
      std::memset(row, 0, 128 * sizeof(float));
      for (int k = 0; k < BVH8_WIDTH; ++k) {  // empty: inverted box
        row[16 * k + 0] = row[16 * k + 1] = row[16 * k + 2] = 1.0f;
        row[16 * k + 3] = row[16 * k + 4] = row[16 * k + 5] = -1.0f;
      }
      const auto &slots = node_children[ni];
      for (int k = 0; k < (int)slots.size(); ++k) {
        const Rec &s = B.recs[slots[k]];
        row[16 * k + 0] = s.box.lo.x;
        row[16 * k + 1] = s.box.lo.y;
        row[16 * k + 2] = s.box.lo.z;
        row[16 * k + 3] = s.box.hi.x;
        row[16 * k + 4] = s.box.hi.y;
        row[16 * k + 5] = s.box.hi.z;
        int32_t link = s.left >= 0 ? wide_index[slots[k]]
                                   : ~leaf_row[slots[k]];
        std::memcpy(row + 16 * k + 6, &link, 4);
      }
    }
  }

  out_counts[0] = n_nodes;
  out_counts[1] = n_wide;
  out_counts[2] = order_len;
  return 0;
}
}
