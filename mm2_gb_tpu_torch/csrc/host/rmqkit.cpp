// rmqkit: native RMQ chaining scores (mg_lchain_rmq analog, lchain.c:250-369).
//
// The outer candidate structure is an exact behavioral emulation of the
// reference's RMQ-augmented AVL tree (csrc/krmq_avl.h): min-priority
// TIES resolve by tree topology, which is part of the byte contract.
// The inner tree is only ever iterated in key order (unique keys), so a
// plain ordered set reproduces it exactly.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <limits>
#include <set>
#include <vector>

#include "krmq_avl.h"

namespace {

inline float fast_log2f(float x) {  // mg_log2 (mmpriv.h:118-126)
    union { float f; uint32_t i; } z = {x};
    float lg = (float)(int)(((z.i >> 23) & 255) - 128);
    z.i &= ~(255u << 23);
    z.i += 127u << 23;
    lg += (-0.34484843f * z.f + 2.02466578f) * z.f - 0.67487759f;
    return lg;
}

struct ScSimple { int32_t sc; bool exact; int32_t width; };

inline ScSimple sc_simple(uint64_t axi, uint64_t ayi, uint64_t axj,
                          uint64_t ayj, float cg, float cs) {
    // comput_sc_simple (lchain.c:230-248)
    int32_t dq = (int32_t)ayi - (int32_t)ayj;
    int32_t dr = (int32_t)axi - (int32_t)axj;
    int32_t dd = dr > dq ? dr - dq : dq - dr;
    int32_t dg = dr < dq ? dr : dq;
    int32_t q_span = (int32_t)(ayj >> 32 & 0xFF);
    int32_t sc = q_span < dg ? q_span : dg;
    bool exact = (dd == 0 && dg <= q_span);
    if (dd || dq > q_span) {
        float lin = cg * (float)dd + cs * (float)dg;
        float lg = dd >= 1 ? fast_log2f((float)(dd + 1)) : 0.0f;
        sc -= (int32_t)(lin + 0.5f * lg);
    }
    return {sc, exact, dd};
}

}  // namespace

extern "C" int64_t mmt_chain_rmq(const uint64_t *ax, const uint64_t *ay,
                                 int64_t n, int32_t max_dist,
                                 int32_t max_dist_inner, int32_t bw,
                                 int32_t max_chn_skip, int32_t cap_rmq_size,
                                 float cg, float cs, int32_t *f,
                                 int64_t *p) {
    if (n == 0) return 0;
    if (max_dist < bw) max_dist = bw;
    if (max_dist_inner <= 0 || max_dist_inner >= max_dist)
        max_dist_inner = 0;
    const bool has_inner = max_dist_inner > 0;

    KrmqAvl outer;
    std::set<int64_t> inner_act;  // active (y,i) keys, key-order iteration
    std::vector<int64_t> t_(n, 0);
    int64_t inner_size = 0;

    auto key_of = [&](int64_t j) {
        // shift via uint64: left-shifting a negative is UB pre-C++20
        return (int64_t)(((uint64_t)(int64_t)(int32_t)ay[j] << 32)
                         | (uint32_t)j);
    };

    int64_t i0 = 0, st = 0, st_inner = 0;
    for (int64_t i = 0; i < n; ++i) {
        int32_t q_span = (int32_t)(ay[i] >> 32 & 0xFF);
        int32_t max_f = q_span;
        int64_t max_j = -1;
        if (i0 < i && ax[i0] != ax[i]) {
            for (int64_t j = i0; j < i; ++j) {
                // pri = -(f[j] + 0.5*cg*((int32)x + (int32)y)) with the
                // reference's wrapping int32 sum (lchain.c:285)
                int32_t sum = (int32_t)((uint32_t)(int32_t)ax[j]
                                        + (uint32_t)(int32_t)ay[j]);
                double pri = -((double)f[j]
                               + 0.5 * (double)cg * (double)sum);
                outer.insert(key_of(j), pri);
                if (has_inner) {
                    inner_act.insert(key_of(j));
                    ++inner_size;
                }
            }
            i0 = i;
        }
        while (st < i && (ax[i] >> 32 != ax[st] >> 32
                          || ax[i] > ax[st] + (uint64_t)max_dist
                          || outer.count > cap_rmq_size)) {
            outer.erase(key_of(st));
            ++st;
        }
        if (has_inner) {
            while (st_inner < i &&
                   (ax[i] >> 32 != ax[st_inner] >> 32
                    || ax[i] > ax[st_inner] + (uint64_t)max_dist_inner
                    || inner_size > cap_rmq_size)) {
                inner_act.erase(key_of(st_inner));
                --inner_size;
                ++st_inner;
            }
        }
        int32_t yi = (int32_t)ay[i];
        // CLOSED krmq interval [(yi-max_dist, INT32_MAX), (yi, 0)]
        int64_t lo_key = (int64_t)(((uint64_t)(int64_t)(yi - max_dist)
                                    << 32) | (uint32_t)INT32_MAX);
        int64_t hi_key = (int64_t)((uint64_t)(int64_t)yi << 32);  // | 0
        int cand = outer.rmq(lo_key, hi_key);
        if (cand >= 0) {
            int64_t j = (int64_t)(uint32_t)outer.nd[cand].key;
            ScSimple s = sc_simple(ax[i], ay[i], ax[j], ay[j], cg, cs);
            int32_t sc = s.sc + f[j];
            if (s.width <= bw && sc > max_f) {
                max_f = sc;
                max_j = j;
            }
            if (!s.exact && has_inner && !inner_act.empty() && yi > 0) {
                int32_t n_skip = 0;
                // descending from (yi-1, +inf) (krmq_interval + itr_prev,
                // lchain.c:328-347)
                int64_t from_key = (int64_t)(((uint64_t)(int64_t)(yi - 1)
                                              << 32)
                                             | (uint32_t)INT32_MAX);
                auto it = inner_act.upper_bound(from_key);
                while (it != inner_act.begin()) {
                    --it;
                    int64_t k = *it;
                    int32_t yj = (int32_t)(k >> 32);
                    int64_t j2 = (int64_t)(uint32_t)k;
                    if (yj < yi - max_dist_inner) break;
                    ScSimple s2 = sc_simple(ax[i], ay[i], ax[j2], ay[j2],
                                            cg, cs);
                    int32_t sc2 = s2.sc + f[j2];
                    if (s2.width <= bw) {
                        if (sc2 > max_f) {
                            max_f = sc2;
                            max_j = j2;
                            if (n_skip > 0) --n_skip;
                        } else if (t_[j2] == i) {
                            if (++n_skip > max_chn_skip) break;
                        }
                        if (p[j2] >= 0) t_[p[j2]] = i;
                    }
                }
            }
        }
        f[i] = max_f;
        p[i] = max_j;
    }
    return n;
}

// score-sorted chain extraction (mg_chain_backtrack, lchain.c:8-76);
// same semantics as ops/chain.py::chain_backtrack
extern "C" int64_t mmt_chain_backtrack(const int32_t *f, const int64_t *p,
                                       int64_t n, int32_t min_cnt,
                                       int32_t min_sc, int32_t max_drop,
                                       const int64_t *z_y, int64_t n_z,
                                       uint64_t *u_out, int64_t *v_out,
                                       int64_t *n_u_out) {
    // z_y: candidate anchor indices sorted ascending by score (host radix)
    std::vector<int8_t> t(n, 0);
    int64_t n_u = 0, n_v = 0;
    for (int64_t k = n_z - 1; k >= 0; --k) {
        int64_t start = z_y[k];
        if (t[start]) continue;
        int32_t zx = f[start];
        // walk with peak-drop cutoff (lchain.c:8-25)
        int64_t i = start, max_i = start, end_i = -1;
        int32_t max_s = 0;
        while (true) {
            t[i] = 2;
            end_i = i = p[i];
            int32_t s = i < 0 ? zx : zx - f[i];
            if (s > max_s) { max_s = s; max_i = i; }
            else if (max_s - s > max_drop) break;
            if (!(i >= 0 && t[i] == 0)) break;
        }
        i = start;
        while (i >= 0 && i != end_i) { t[i] = 0; i = p[i]; }
        end_i = max_i;
        // emit
        int64_t v0 = n_v;
        i = start;
        while (i != end_i) {
            v_out[n_v++] = i;
            t[i] = 1;
            i = p[i];
        }
        int32_t sc = i < 0 ? zx : zx - f[i];
        int64_t cnt = n_v - v0;
        if (sc >= min_sc && cnt > 0 && cnt >= min_cnt)
            u_out[n_u++] = ((uint64_t)(uint32_t)sc << 32) | (uint64_t)cnt;
        else
            n_v = v0;
    }
    *n_u_out = n_u;
    return n_v;
}
