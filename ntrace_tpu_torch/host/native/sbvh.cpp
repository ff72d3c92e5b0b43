// Native SBVH / binned-SAH host builder.
//
// Reference parity: the upstream SplitBVHBuilder is C++ (expected
// rt/bvh/SplitBVHBuilder.{cpp,hpp}; Stich, Friedrich & Dietrich 2009).
// This is the native counterpart of ntrace_tpu/bvh/sbvh.py: the SAME
// algorithm (binned or full-sweep SAH object splits, binned spatial
// splits gated by alpha * root_area overlap, Stich SS4.4 reference
// unsplitting, identical leaf/termination rules) built for the 10M-tri
// offline configs where the Python builder's per-node numpy overhead
// dominates (San Miguel SBVH: ~10 min/chunk Python).
//
// Trees are not guaranteed bit-identical to the Python builder (float
// accumulation order differs in the prefix sweeps); both are validated
// by the same structural invariants + brute-force traversal tests, and
// SAH cost parity is asserted in tests/test_sbvh.py.
//
// Exposed via ctypes (see native/sbvh.py): plain C ABI, caller frees
// with sbvh_result_free.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();
constexpr float kFInf = std::numeric_limits<float>::infinity();

struct Ref {
    float lo[3];
    float hi[3];
    int32_t tri;
};

struct Cfg {
    int spatial;        // builder == "sbvh"
    int unsplit;        // cfg.sbvh_unsplit
    int sweep;          // cfg.object_sweep
    int num_object_bins;
    int num_spatial_bins;
    float node_cost;
    float tri_cost;
    float alpha;
    int min_leaf;
    int max_leaf;
    int max_depth;
};

inline double area(const float lo[3], const float hi[3]) {
    double dx = std::max(0.0f, hi[0] - lo[0]);
    double dy = std::max(0.0f, hi[1] - lo[1]);
    double dz = std::max(0.0f, hi[2] - lo[2]);
    return 2.0 * (dx * dy + dy * dz + dz * dx);
}

struct Box {
    float lo[3] = {kFInf, kFInf, kFInf};
    float hi[3] = {-kFInf, -kFInf, -kFInf};
    void grow(const float l[3], const float h[3]) {
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], l[a]);
            hi[a] = std::max(hi[a], h[a]);
        }
    }
    void grow(const Box& b) { grow(b.lo, b.hi); }
    double sa() const { return area(lo, hi); }
    bool valid() const { return lo[0] <= hi[0]; }
};

struct SplitChoice {
    double sah = kInf;
    int axis = -1;
    // Object split: bin threshold (binned) or sorted position (sweep).
    // Spatial split: plane coordinate.
    int bin_k = -1;
    double plane = 0.0;
    bool is_spatial = false;
    bool is_sweep = false;
};

class Builder {
public:
    Builder(const float* lo, const float* hi, int64_t n, const Cfg& cfg)
        : cfg_(cfg) {
        refs_.resize(static_cast<size_t>(n));
        Box root;
        for (int64_t i = 0; i < n; ++i) {
            Ref& r = refs_[static_cast<size_t>(i)];
            std::memcpy(r.lo, lo + 3 * i, 3 * sizeof(float));
            std::memcpy(r.hi, hi + 3 * i, 3 * sizeof(float));
            r.tri = static_cast<int32_t>(i);
            root.grow(r.lo, r.hi);
        }
        min_overlap_ = cfg.alpha * root.sa();
        // Pre-order node ids mirror the Python builder (node appended
        // before recursing into children).
        child_.reserve(static_cast<size_t>(2 * n));
    }

    // Returns root node id (>= 0 internal, < 0 encodes leaf ~id).
    int32_t run() {
        std::vector<Ref> all;
        all.swap(refs_);
        return build(std::move(all), 0);
    }

    std::vector<int32_t> child_;        // (I, 2)
    std::vector<float> child_lo_;       // (I, 2, 3)
    std::vector<float> child_hi_;       // (I, 2, 3)
    std::vector<int32_t> leaf_first_;
    std::vector<int32_t> leaf_count_;
    std::vector<int32_t> tri_order_;
    int64_t n_refs_final_ = 0;
    int64_t unsplit_count_ = 0;

private:
    Cfg cfg_;
    double min_overlap_ = 0.0;
    std::vector<Ref> refs_;  // only used during construction

    int32_t make_leaf(std::vector<Ref>& refs) {
        // Deduplicate tri ids (spatial splits may put both fragments of a
        // triangle into the same leaf); sorted ascending like np.unique.
        std::vector<int32_t> tris;
        tris.reserve(refs.size());
        Box b;
        for (const Ref& r : refs) {
            tris.push_back(r.tri);
            b.grow(r.lo, r.hi);
        }
        std::sort(tris.begin(), tris.end());
        tris.erase(std::unique(tris.begin(), tris.end()), tris.end());
        int32_t id = static_cast<int32_t>(leaf_first_.size());
        leaf_first_.push_back(static_cast<int32_t>(tri_order_.size()));
        leaf_count_.push_back(static_cast<int32_t>(tris.size()));
        tri_order_.insert(tri_order_.end(), tris.begin(), tris.end());
        leaf_lo_.push_back(b);
        n_refs_final_ += static_cast<int64_t>(refs.size());
        return ~id;
    }

    std::vector<Box> leaf_lo_;  // creation-time box per leaf

    Box child_bounds(int32_t c, size_t node_base) const {
        if (c < 0) return leaf_lo_[static_cast<size_t>(~c)];
        Box b;
        size_t i = static_cast<size_t>(c);
        b.grow(&child_lo_[6 * i], &child_hi_[6 * i]);
        b.grow(&child_lo_[6 * i + 3], &child_hi_[6 * i + 3]);
        (void)node_base;
        return b;
    }

    // Binned SAH object split over centroids (sbvh.py _object_split).
    SplitChoice object_split_binned(const std::vector<Ref>& refs) {
        const int nb = cfg_.num_object_bins;
        SplitChoice best;
        float clo[3] = {kFInf, kFInf, kFInf}, chi[3] = {-kFInf, -kFInf, -kFInf};
        std::vector<float> cent(refs.size() * 3);
        for (size_t i = 0; i < refs.size(); ++i) {
            for (int a = 0; a < 3; ++a) {
                float c = 0.5f * (refs[i].lo[a] + refs[i].hi[a]);
                cent[3 * i + a] = c;
                clo[a] = std::min(clo[a], c);
                chi[a] = std::max(chi[a], c);
            }
        }
        std::vector<int64_t> cnt(static_cast<size_t>(nb));
        std::vector<Box> bins(static_cast<size_t>(nb));
        std::vector<double> lsa(static_cast<size_t>(nb)), rsa(static_cast<size_t>(nb));
        std::vector<int64_t> lcnt(static_cast<size_t>(nb)), rcnt(static_cast<size_t>(nb));
        for (int axis = 0; axis < 3; ++axis) {
            if (chi[axis] <= clo[axis]) continue;
            float scale = nb / (chi[axis] - clo[axis]);
            std::fill(cnt.begin(), cnt.end(), 0);
            std::fill(bins.begin(), bins.end(), Box());
            for (size_t i = 0; i < refs.size(); ++i) {
                int b = std::min(static_cast<int>((cent[3 * i + axis] - clo[axis]) * scale),
                                 nb - 1);
                cnt[static_cast<size_t>(b)]++;
                bins[static_cast<size_t>(b)].grow(refs[i].lo, refs[i].hi);
            }
            sweep_bins(bins, cnt, lsa, rsa, lcnt, rcnt);
            for (int k = 0; k < nb - 1; ++k) {
                if (lcnt[k] == 0 || rcnt[k + 1] == 0) continue;
                double sah = lcnt[k] * lsa[k] + rcnt[k + 1] * rsa[k + 1];
                if (sah < best.sah) {
                    best.sah = sah;
                    best.axis = axis;
                    best.bin_k = k;
                    best.plane = clo[axis];        // reuse: bin origin
                    best.is_spatial = false;
                    best.is_sweep = false;
                    obj_scale_ = scale;
                    obj_origin_ = clo[axis];
                }
            }
        }
        return best;
    }

    // Full-sweep SAH object split (sbvh.py _object_split_sweep; the
    // reference SplitBVHBuilder sorts refs per axis and evaluates every
    // split position).
    SplitChoice object_split_sweep(std::vector<Ref>& refs) {
        const size_t n = refs.size();
        SplitChoice best;
        std::vector<uint32_t> order(n);
        std::vector<double> rarea(n);
        for (int axis = 0; axis < 3; ++axis) {
            for (uint32_t i = 0; i < n; ++i) order[i] = i;
            std::stable_sort(order.begin(), order.end(),
                             [&](uint32_t a, uint32_t b) {
                                 float ca = refs[a].lo[axis] + refs[a].hi[axis];
                                 float cb = refs[b].lo[axis] + refs[b].hi[axis];
                                 return ca < cb;
                             });
            // Suffix areas.
            Box b;
            for (size_t i = n; i-- > 0;) {
                b.grow(refs[order[i]].lo, refs[order[i]].hi);
                rarea[i] = b.sa();
            }
            // Prefix sweep.
            Box l;
            for (size_t k = 0; k + 1 < n; ++k) {
                l.grow(refs[order[k]].lo, refs[order[k]].hi);
                double sah = static_cast<double>(k + 1) * l.sa()
                           + static_cast<double>(n - k - 1) * rarea[k + 1];
                if (sah < best.sah) {
                    best.sah = sah;
                    best.axis = axis;
                    best.bin_k = static_cast<int>(k);
                    best.is_sweep = true;
                    best.is_spatial = false;
                }
            }
        }
        return best;
    }

    // Binned spatial split (sbvh.py _spatial_split). Entry/exit counting
    // with refs clipped to each slab they span; the pathological-spanning
    // branch approximates bin bounds by the slab extent.
    SplitChoice spatial_split(const Box& node, const std::vector<Ref>& refs) {
        const int nb = cfg_.num_spatial_bins;
        SplitChoice best;
        std::vector<int64_t> entry(static_cast<size_t>(nb)), exit_(static_cast<size_t>(nb));
        std::vector<Box> bins(static_cast<size_t>(nb));
        std::vector<double> lsa(static_cast<size_t>(nb)), rsa(static_cast<size_t>(nb));
        std::vector<int64_t> lcnt(static_cast<size_t>(nb)), rcnt(static_cast<size_t>(nb));
        for (int axis = 0; axis < 3; ++axis) {
            double ext = static_cast<double>(node.hi[axis]) - node.lo[axis];
            if (ext <= 0) continue;
            double scale = nb / ext;
            std::fill(entry.begin(), entry.end(), 0);
            std::fill(exit_.begin(), exit_.end(), 0);
            std::fill(bins.begin(), bins.end(), Box());
            int64_t pairs_total = 0;
            for (const Ref& r : refs) {
                int b0 = clamp_bin(static_cast<int>((r.lo[axis] - node.lo[axis]) * scale), nb);
                int b1 = clamp_bin(static_cast<int>((r.hi[axis] - node.lo[axis]) * scale), nb);
                pairs_total += (b1 - b0 + 1);
                entry[static_cast<size_t>(b0)]++;
                exit_[static_cast<size_t>(b1)]++;
            }
            if (pairs_total > 16 * static_cast<int64_t>(refs.size())) {
                // Pathologically spanning refs: slab-extent approximation.
                for (int b = 0; b < nb; ++b) {
                    Box s;
                    std::memcpy(s.lo, node.lo, sizeof s.lo);
                    std::memcpy(s.hi, node.hi, sizeof s.hi);
                    s.lo[axis] = static_cast<float>(node.lo[axis] + b / scale);
                    s.hi[axis] = static_cast<float>(node.lo[axis] + (b + 1) / scale);
                    bins[static_cast<size_t>(b)] = s;
                }
            } else {
                for (const Ref& r : refs) {
                    int b0 = clamp_bin(static_cast<int>((r.lo[axis] - node.lo[axis]) * scale), nb);
                    int b1 = clamp_bin(static_cast<int>((r.hi[axis] - node.lo[axis]) * scale), nb);
                    for (int b = b0; b <= b1; ++b) {
                        float el = static_cast<float>(node.lo[axis] + b / scale);
                        float eh = static_cast<float>(node.lo[axis] + (b + 1) / scale);
                        Box c;
                        std::memcpy(c.lo, r.lo, sizeof c.lo);
                        std::memcpy(c.hi, r.hi, sizeof c.hi);
                        c.lo[axis] = std::max(c.lo[axis], el);
                        c.hi[axis] = std::min(c.hi[axis], eh);
                        bins[static_cast<size_t>(b)].grow(c.lo, c.hi);
                    }
                }
            }
            // Prefix/suffix with entry/exit counts.
            {
                Box l;
                int64_t c = 0;
                for (int k = 0; k < nb; ++k) {
                    l.grow(bins[static_cast<size_t>(k)]);
                    c += entry[static_cast<size_t>(k)];
                    lsa[static_cast<size_t>(k)] = l.valid() ? l.sa() : kInf;
                    lcnt[static_cast<size_t>(k)] = c;
                }
                Box r;
                c = 0;
                for (int k = nb; k-- > 0;) {
                    r.grow(bins[static_cast<size_t>(k)]);
                    c += exit_[static_cast<size_t>(k)];
                    rsa[static_cast<size_t>(k)] = r.valid() ? r.sa() : kInf;
                    rcnt[static_cast<size_t>(k)] = c;
                }
            }
            for (int k = 0; k < nb - 1; ++k) {
                if (lcnt[static_cast<size_t>(k)] == 0 ||
                    rcnt[static_cast<size_t>(k + 1)] == 0)
                    continue;
                double sah = lcnt[static_cast<size_t>(k)] * lsa[static_cast<size_t>(k)]
                           + rcnt[static_cast<size_t>(k + 1)] * rsa[static_cast<size_t>(k + 1)];
                if (sah < best.sah) {
                    best.sah = sah;
                    best.axis = axis;
                    best.is_spatial = true;
                    best.plane = node.lo[axis] + (k + 1) / scale;
                }
            }
        }
        return best;
    }

    static int clamp_bin(int b, int nb) {
        return b < 0 ? 0 : (b >= nb ? nb - 1 : b);
    }

    void sweep_bins(const std::vector<Box>& bins, const std::vector<int64_t>& cnt,
                    std::vector<double>& lsa, std::vector<double>& rsa,
                    std::vector<int64_t>& lcnt, std::vector<int64_t>& rcnt) {
        const size_t nb = bins.size();
        Box l;
        int64_t c = 0;
        for (size_t k = 0; k < nb; ++k) {
            l.grow(bins[k]);
            c += cnt[k];
            lsa[k] = l.valid() ? l.sa() : kInf;
            lcnt[k] = c;
        }
        Box r;
        c = 0;
        for (size_t k = nb; k-- > 0;) {
            r.grow(bins[k]);
            c += cnt[k];
            rsa[k] = r.valid() ? r.sa() : kInf;
            rcnt[k] = c;
        }
    }

    // Partition by the chosen OBJECT split into (left, right); consumes refs.
    void apply_object(std::vector<Ref>&& refs, const SplitChoice& s,
                      std::vector<Ref>& left, std::vector<Ref>& right) {
        if (s.is_sweep) {
            const size_t n = refs.size();
            std::vector<uint32_t> order(n);
            for (uint32_t i = 0; i < n; ++i) order[i] = i;
            int axis = s.axis;
            std::stable_sort(order.begin(), order.end(),
                             [&](uint32_t a, uint32_t b) {
                                 float ca = refs[a].lo[axis] + refs[a].hi[axis];
                                 float cb = refs[b].lo[axis] + refs[b].hi[axis];
                                 return ca < cb;
                             });
            size_t k = static_cast<size_t>(s.bin_k) + 1;
            left.reserve(k);
            right.reserve(n - k);
            for (size_t i = 0; i < n; ++i)
                (i < k ? left : right).push_back(refs[order[i]]);
        } else {
            for (const Ref& r : refs) {
                float c = 0.5f * (r.lo[s.axis] + r.hi[s.axis]);
                int b = std::min(static_cast<int>((c - obj_origin_) * obj_scale_),
                                 cfg_.num_object_bins - 1);
                (b <= s.bin_k ? left : right).push_back(r);
            }
        }
        refs.clear();
        refs.shrink_to_fit();
    }

    // Spatial partition with Stich SS4.4 reference unsplitting
    // (sbvh.py _apply_spatial). Consumes refs.
    void apply_spatial(std::vector<Ref>&& refs, int axis, float plane,
                       std::vector<Ref>& left, std::vector<Ref>& right) {
        std::vector<Ref> strad;
        Box bl, br;           // bounds of the pure sides
        for (const Ref& r : refs) {
            if (r.hi[axis] <= plane) {
                left.push_back(r);
                bl.grow(r.lo, r.hi);
            } else if (r.lo[axis] >= plane) {
                right.push_back(r);
                br.grow(r.lo, r.hi);
            } else {
                strad.push_back(r);
            }
        }
        refs.clear();
        refs.shrink_to_fit();
        if (!strad.empty() && cfg_.unsplit) {
            // Baseline (every straddler split): child bounds include the
            // clipped fragments.
            Box blb = bl, brb = br;
            for (const Ref& r : strad) {
                Ref lf = r, rf = r;
                lf.hi[axis] = std::min(lf.hi[axis], plane);
                rf.lo[axis] = std::max(rf.lo[axis], plane);
                blb.grow(lf.lo, lf.hi);
                brb.grow(rf.lo, rf.hi);
            }
            int64_t nl = static_cast<int64_t>(left.size() + strad.size());
            int64_t nr = static_cast<int64_t>(right.size() + strad.size());
            double sa_l = blb.sa();
            double sa_r = brb.sa();
            double c_split = sa_l * nl + sa_r * nr;
            std::vector<Ref> keep;
            keep.reserve(strad.size());
            for (const Ref& r : strad) {
                Box gl = blb, gr = brb;
                gl.grow(r.lo, r.hi);
                gr.grow(r.lo, r.hi);
                double c_left = gl.sa() * nl + sa_r * (nr - 1);
                double c_right = sa_l * (nl - 1) + gr.sa() * nr;
                bool go_left = (c_left < c_split) && (c_left <= c_right);
                bool go_right = (c_right < c_split) && (c_right < c_left);
                if (go_left) {
                    left.push_back(r);
                    unsplit_count_++;
                } else if (go_right) {
                    right.push_back(r);
                    unsplit_count_++;
                } else {
                    keep.push_back(r);
                }
            }
            strad.swap(keep);
        }
        for (const Ref& r : strad) {
            Ref lf = r, rf = r;
            lf.hi[axis] = std::min(lf.hi[axis], plane);
            rf.lo[axis] = std::max(rf.lo[axis], plane);
            left.push_back(lf);
            right.push_back(rf);
        }
    }

    int32_t median_fallback(std::vector<Ref>&& refs, int depth) {
        // Widest centroid axis, split at the median (sbvh.py
        // _median_fallback).
        float clo[3] = {kFInf, kFInf, kFInf}, chi[3] = {-kFInf, -kFInf, -kFInf};
        for (const Ref& r : refs) {
            for (int a = 0; a < 3; ++a) {
                float c = 0.5f * (r.lo[a] + r.hi[a]);
                clo[a] = std::min(clo[a], c);
                chi[a] = std::max(chi[a], c);
            }
        }
        int axis = 0;
        float w = chi[0] - clo[0];
        for (int a = 1; a < 3; ++a)
            if (chi[a] - clo[a] > w) { w = chi[a] - clo[a]; axis = a; }
        size_t k = refs.size() / 2;
        std::nth_element(refs.begin(), refs.begin() + static_cast<long>(k), refs.end(),
                         [axis](const Ref& a, const Ref& b) {
                             return a.lo[axis] + a.hi[axis] < b.lo[axis] + b.hi[axis];
                         });
        std::vector<Ref> left(refs.begin(), refs.begin() + static_cast<long>(k));
        std::vector<Ref> right(refs.begin() + static_cast<long>(k), refs.end());
        refs.clear();
        refs.shrink_to_fit();
        return emit_node(std::move(left), std::move(right), depth);
    }

    int32_t emit_node(std::vector<Ref>&& left, std::vector<Ref>&& right, int depth) {
        int32_t node = static_cast<int32_t>(child_.size() / 2);
        child_.push_back(0);
        child_.push_back(0);
        child_lo_.insert(child_lo_.end(), 6, 0.0f);
        child_hi_.insert(child_hi_.end(), 6, 0.0f);
        int32_t c0 = build(std::move(left), depth + 1);
        int32_t c1 = build(std::move(right), depth + 1);
        child_[2 * static_cast<size_t>(node)] = c0;
        child_[2 * static_cast<size_t>(node) + 1] = c1;
        Box b0 = child_bounds(c0, 0);
        Box b1 = child_bounds(c1, 0);
        float* plo = &child_lo_[6 * static_cast<size_t>(node)];
        float* phi = &child_hi_[6 * static_cast<size_t>(node)];
        std::memcpy(plo, b0.lo, 3 * sizeof(float));
        std::memcpy(plo + 3, b1.lo, 3 * sizeof(float));
        std::memcpy(phi, b0.hi, 3 * sizeof(float));
        std::memcpy(phi + 3, b1.hi, 3 * sizeof(float));
        return node;
    }

    int32_t build(std::vector<Ref>&& refs, int depth) {
        const size_t count = refs.size();
        Box node;
        for (const Ref& r : refs) node.grow(r.lo, r.hi);
        double node_area = std::max(node.sa(), 1e-30);

        if (count <= static_cast<size_t>(cfg_.min_leaf) || depth >= cfg_.max_depth)
            return make_leaf(refs);

        SplitChoice obj = cfg_.sweep ? object_split_sweep(refs)
                                     : object_split_binned(refs);

        SplitChoice spa;
        if (cfg_.spatial && obj.axis >= 0) {
            // Overlap of the object split's children gates spatial splits.
            Box l, r;
            partition_bounds(refs, obj, l, r);
            Box ov;
            bool has_ov = true;
            for (int a = 0; a < 3; ++a) {
                ov.lo[a] = std::max(l.lo[a], r.lo[a]);
                ov.hi[a] = std::min(l.hi[a], r.hi[a]);
                if (ov.hi[a] <= ov.lo[a]) has_ov = false;
            }
            if (has_ov && ov.sa() > min_overlap_)
                spa = spatial_split(node, refs);
        }

        double leaf_sah = static_cast<double>(count) * cfg_.tri_cost * node_area;
        double best_split = std::min(obj.sah, spa.sah);
        double split_sah = cfg_.node_cost * node_area + cfg_.tri_cost * best_split;
        if (count <= static_cast<size_t>(cfg_.max_leaf) && leaf_sah <= split_sah)
            return make_leaf(refs);
        if (!std::isfinite(best_split)) {
            if (count <= static_cast<size_t>(std::max(cfg_.max_leaf, 64)))
                return make_leaf(refs);
            return median_fallback(std::move(refs), depth);
        }

        std::vector<Ref> left, right;
        if (spa.sah < obj.sah) {
            apply_spatial(std::move(refs), spa.axis,
                          static_cast<float>(spa.plane), left, right);
            if (left.empty() || right.empty()) {
                // Degenerate spatial partition: redo as the object split.
                // (refs was consumed; rebuild from left+right which
                // together hold every fragment — but a degenerate side
                // means no straddlers were clipped, so the union is the
                // original ref set.)
                std::vector<Ref> all;
                all.reserve(left.size() + right.size());
                all.insert(all.end(), left.begin(), left.end());
                all.insert(all.end(), right.begin(), right.end());
                left.clear();
                right.clear();
                apply_object(std::move(all), obj, left, right);
            }
        } else {
            apply_object(std::move(refs), obj, left, right);
        }
        return emit_node(std::move(left), std::move(right), depth);
    }

    // Bounds of the two sides of an object split without materializing
    // the partition (used only for the spatial-split overlap gate).
    void partition_bounds(const std::vector<Ref>& refs, const SplitChoice& s,
                          Box& l, Box& r) {
        if (s.is_sweep) {
            // Sweep split: sides are the first k+1 / rest in sorted order.
            const size_t n = refs.size();
            std::vector<uint32_t> order(n);
            for (uint32_t i = 0; i < n; ++i) order[i] = i;
            int axis = s.axis;
            std::stable_sort(order.begin(), order.end(),
                             [&](uint32_t a, uint32_t b) {
                                 float ca = refs[a].lo[axis] + refs[a].hi[axis];
                                 float cb = refs[b].lo[axis] + refs[b].hi[axis];
                                 return ca < cb;
                             });
            size_t k = static_cast<size_t>(s.bin_k) + 1;
            for (size_t i = 0; i < n; ++i)
                (i < k ? l : r).grow(refs[order[i]].lo, refs[order[i]].hi);
        } else {
            for (const Ref& ref : refs) {
                float c = 0.5f * (ref.lo[s.axis] + ref.hi[s.axis]);
                int b = std::min(static_cast<int>((c - obj_origin_) * obj_scale_),
                                 cfg_.num_object_bins - 1);
                (b <= s.bin_k ? l : r).grow(ref.lo, ref.hi);
            }
        }
    }

    // Scale/origin of the winning binned object axis (set by
    // object_split_binned when it improves best).
    float obj_scale_ = 0.0f;
    float obj_origin_ = 0.0f;
};

}  // namespace

extern "C" {

struct SbvhResult {
    int32_t* child;       // (I, 2)
    float* child_lo;      // (I, 2, 3)
    float* child_hi;      // (I, 2, 3)
    int64_t n_inner;
    int32_t* leaf_first;  // (L,)
    int32_t* leaf_count;  // (L,)
    int64_t n_leaves;
    int32_t* tri_order;   // (K,)
    int64_t n_order;
    int64_t n_refs;       // final reference count (duplication diagnostic)
    int64_t unsplit;      // straddlers kept whole (Stich SS4.4)
    int32_t root;         // >= 0 internal; < 0: whole scene is one leaf
    const char* error;    // NULL on success (points at static storage)
};

static int32_t* copy_i32(const std::vector<int32_t>& v) {
    auto* p = static_cast<int32_t*>(std::malloc(std::max<size_t>(v.size(), 1) * 4));
    if (p && !v.empty()) std::memcpy(p, v.data(), v.size() * 4);
    return p;
}

static float* copy_f32(const std::vector<float>& v) {
    auto* p = static_cast<float*>(std::malloc(std::max<size_t>(v.size(), 1) * 4));
    if (p && !v.empty()) std::memcpy(p, v.data(), v.size() * 4);
    return p;
}

SbvhResult* sbvh_build(const float* lo, const float* hi, int64_t n,
                       int spatial, int unsplit, int sweep,
                       int num_object_bins, int num_spatial_bins,
                       float node_cost, float tri_cost, float alpha,
                       int min_leaf, int max_leaf, int max_depth) {
    auto* out = static_cast<SbvhResult*>(std::calloc(1, sizeof(SbvhResult)));
    if (!out) return nullptr;
    if (n < 1) {
        out->error = "sbvh_build: need at least 1 box";
        return out;
    }
    try {
        Cfg cfg{spatial, unsplit, sweep, num_object_bins, num_spatial_bins,
                node_cost, tri_cost, alpha, min_leaf, max_leaf, max_depth};
        Builder b(lo, hi, n, cfg);
        int32_t root = b.run();
        out->child = copy_i32(b.child_);
        out->child_lo = copy_f32(b.child_lo_);
        out->child_hi = copy_f32(b.child_hi_);
        out->n_inner = static_cast<int64_t>(b.child_.size() / 2);
        out->leaf_first = copy_i32(b.leaf_first_);
        out->leaf_count = copy_i32(b.leaf_count_);
        out->n_leaves = static_cast<int64_t>(b.leaf_first_.size());
        out->tri_order = copy_i32(b.tri_order_);
        out->n_order = static_cast<int64_t>(b.tri_order_.size());
        out->n_refs = b.n_refs_final_;
        out->unsplit = b.unsplit_count_;
        out->root = root;
        out->error = nullptr;
    } catch (const std::bad_alloc&) {
        out->error = "sbvh_build: out of memory";
    } catch (...) {
        out->error = "sbvh_build: internal error";
    }
    return out;
}

void sbvh_result_free(SbvhResult* r) {
    if (!r) return;
    std::free(r->child);
    std::free(r->child_lo);
    std::free(r->child_hi);
    std::free(r->leaf_first);
    std::free(r->leaf_count);
    std::free(r->tri_order);
    std::free(r);
}

}  // extern "C"
