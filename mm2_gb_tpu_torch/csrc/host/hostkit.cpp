// hostkit: native implementations of the sequential host-side components.
//
// The TPU owns the chaining/alignment compute path; these routines cover the
// remaining host work that is too branchy/sequential for vector units:
//   - mmt_sketch:        (w,k)-minimizer sketch (semantics of sketch.c:77-143)
//   - mmt_radix_perm64:  the permutation of the reference's unstable MSD
//                        radix sort on a 64-bit key (ksort.h), needed for
//                        byte-exact tie ordering
//   - mmt_chain_dp:      backward chain DP scores/predecessors
//                        (mg_lchain_dp core, lchain.c:169-207) with
//                        max_skip = infinity — the host fallback for
//                        segments that exceed device capacity
//
// Exposed with C linkage and called from Python via ctypes
// (mm2_gb_tpu/utils/native.py).  Each function is cross-checked against the
// pure-Python oracles in tests/.

#include <array>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// minimizer sketch
// ---------------------------------------------------------------------------

constexpr uint64_t U64MAX = ~0ULL;

inline uint64_t mix64(uint64_t key, uint64_t mask) {
    key = (~key + (key << 21)) & mask;
    key ^= key >> 24;
    key = (key + (key << 3) + (key << 8)) & mask;
    key ^= key >> 14;
    key = (key + (key << 2) + (key << 4)) & mask;
    key ^= key >> 28;
    key = (key + (key << 31)) & mask;
    return key;
}

const int8_t* base_code_table() {
    // C++11 magic-static init: thread-safe now that seeding fans out
    // over a pool (a plain bool guard could publish before the stores)
    static const std::array<int8_t, 256> tbl = [] {
        std::array<int8_t, 256> t;
        t.fill(4);
        t['A'] = t['a'] = 0;
        t['C'] = t['c'] = 1;
        t['G'] = t['g'] = 2;
        t['T'] = t['t'] = 3;
        t['U'] = t['u'] = 3;
        return t;
    }();
    return tbl.data();
}

struct MiniPair { uint64_t x, y; };

}  // namespace

extern "C" {

// Returns the number of minimizers written (pairs), or -1 on overflow.
// out receives x,y interleaved.
int64_t mmt_sketch(const char* seq, int64_t len, int w, int k, uint32_t rid,
                   int is_hpc, uint64_t* out, int64_t cap_words) {
    const int8_t* tbl = base_code_table();
    const uint64_t mask = (1ULL << (2 * k)) - 1;
    const int shift1 = 2 * (k - 1);
    int64_t n_out = 0;
    auto emit = [&](const MiniPair& m) -> bool {
        if (2 * n_out + 1 >= cap_words) return false;
        out[2 * n_out] = m.x;
        out[2 * n_out + 1] = m.y;
        ++n_out;
        return true;
    };

    std::vector<MiniPair> ring(w, {U64MAX, U64MAX});
    MiniPair cur_min = {U64MAX, U64MAX};
    int min_slot = 0, slot = 0;
    uint64_t fwd = 0, rev = 0;
    int run_len_q[32];  // HPC run-length queue (tiny ring, matches k<=28)
    int q_front = 0, q_count = 0;
    int l = 0, span = 0;
    const uint64_t rid_hi = (uint64_t)rid << 32;

    for (int64_t i = 0; i < len; ++i) {
        int c = tbl[(uint8_t)seq[i]];
        MiniPair info = {U64MAX, U64MAX};
        if (c < 4) {
            if (is_hpc) {
                int run = 1;
                if (i + 1 < len && tbl[(uint8_t)seq[i + 1]] == c) {
                    for (run = 2; i + run < len; ++run)
                        if (tbl[(uint8_t)seq[i + run]] != c) break;
                    i += run - 1;
                }
                run_len_q[(q_front + q_count++) & 31] = run;
                span += run;
                if (q_count > k) {
                    span -= run_len_q[q_front];
                    q_front = (q_front + 1) & 31;
                    --q_count;
                }
            } else {
                span = l + 1 < k ? l + 1 : k;
            }
            fwd = ((fwd << 2) | c) & mask;
            rev = (rev >> 2) | ((uint64_t)(3 ^ c) << shift1);
            if (fwd == rev) continue;  // strand-symmetric k-mer
            int strand = fwd < rev ? 0 : 1;
            ++l;
            if (l >= k && span < 256) {
                info.x = mix64(strand ? rev : fwd, mask) << 8 | span;
                info.y = rid_hi | (uint64_t)(uint32_t)i << 1 | strand;
            }
        } else {
            l = 0;
            q_front = q_count = 0;
            span = 0;
        }
        ring[slot] = info;
        if (l == w + k - 1 && cur_min.x != U64MAX) {
            for (int j = slot + 1; j < w; ++j)
                if (cur_min.x == ring[j].x && ring[j].y != cur_min.y)
                    if (!emit(ring[j])) return -1;
            for (int j = 0; j < slot; ++j)
                if (cur_min.x == ring[j].x && ring[j].y != cur_min.y)
                    if (!emit(ring[j])) return -1;
        }
        if (info.x <= cur_min.x) {
            if (l >= w + k && cur_min.x != U64MAX)
                if (!emit(cur_min)) return -1;
            cur_min = info;
            min_slot = slot;
        } else if (slot == min_slot) {
            if (l >= w + k - 1 && cur_min.x != U64MAX)
                if (!emit(cur_min)) return -1;
            cur_min.x = U64MAX;
            for (int j = slot + 1; j < w; ++j)
                if (cur_min.x >= ring[j].x) { cur_min = ring[j]; min_slot = j; }
            for (int j = 0; j <= slot; ++j)
                if (cur_min.x >= ring[j].x) { cur_min = ring[j]; min_slot = j; }
            if (l >= w + k - 1 && cur_min.x != U64MAX) {
                for (int j = slot + 1; j < w; ++j)
                    if (cur_min.x == ring[j].x && cur_min.y != ring[j].y)
                        if (!emit(ring[j])) return -1;
                for (int j = 0; j <= slot; ++j)
                    if (cur_min.x == ring[j].x && cur_min.y != ring[j].y)
                        if (!emit(ring[j])) return -1;
            }
        }
        if (++slot == w) slot = 0;
    }
    if (cur_min.x != U64MAX)
        if (!emit(cur_min)) return -1;
    return n_out;
}

// ---------------------------------------------------------------------------
// radix permutation (ksort.h semantics on a 64-bit key)
// ---------------------------------------------------------------------------

namespace {

constexpr int kRsMinSize = 64;

void insertion_perm(const uint64_t* keys, int64_t* perm, int64_t lo, int64_t hi) {
    for (int64_t i = lo + 1; i < hi; ++i) {
        uint64_t ki = keys[perm[i]];
        if (ki < keys[perm[i - 1]]) {
            int64_t pi = perm[i], j = i;
            for (; j > lo && ki < keys[perm[j - 1]]; --j) perm[j] = perm[j - 1];
            perm[j] = pi;
        }
    }
}

void rs_sort_perm(const uint64_t* keys, int64_t* perm, int64_t lo, int64_t hi,
                  int shift) {
    int64_t cnt[256] = {0};
    for (int64_t i = lo; i < hi; ++i)
        ++cnt[(keys[perm[i]] >> shift) & 0xFF];
    int64_t starts[256], ends[256], cur[256];
    int64_t acc = lo;
    for (int b = 0; b < 256; ++b) {
        starts[b] = cur[b] = acc;
        acc += cnt[b];
        ends[b] = acc;
    }
    for (int b = 0; b < 256;) {
        if (cur[b] == ends[b]) { ++b; continue; }
        int tgt = (keys[perm[cur[b]]] >> shift) & 0xFF;
        if (tgt == b) { ++cur[b]; continue; }
        int64_t tmp = perm[cur[b]];
        do {
            int64_t swap = tmp;
            tmp = perm[cur[tgt]];
            perm[cur[tgt]++] = swap;
            tgt = (keys[tmp] >> shift) & 0xFF;
        } while (tgt != b);
        perm[cur[b]++] = tmp;
    }
    if (shift) {
        int nxt = shift > 8 ? shift - 8 : 0;
        for (int b = 0; b < 256; ++b) {
            if (cnt[b] > kRsMinSize)
                rs_sort_perm(keys, perm, starts[b], ends[b], nxt);
            else if (cnt[b] > 1)
                insertion_perm(keys, perm, starts[b], ends[b]);
        }
    }
}

}  // namespace

void mmt_radix_perm64(const uint64_t* keys, int64_t n, int64_t* perm) {
    for (int64_t i = 0; i < n; ++i) perm[i] = i;
    if (n <= kRsMinSize) insertion_perm(keys, perm, 0, n);
    else rs_sort_perm(keys, perm, 0, n, 56);
}

// ---------------------------------------------------------------------------
// chain DP (host fallback / oracle fast path), max_skip = infinity
// ---------------------------------------------------------------------------

namespace {

inline float fast_log2f(float x) {  // mg_log2 (mmpriv.h:118-126)
    union { float f; uint32_t i; } z = {x};
    float lg = (float)(int)(((z.i >> 23) & 255) - 128);
    z.i &= ~(255u << 23);
    z.i += 127u << 23;
    lg += (-0.34484843f * z.f + 2.02466578f) * z.f - 0.67487759f;
    return lg;
}

inline int32_t pair_score(uint64_t axi, uint64_t ayi, uint64_t axj, uint64_t ayj,
                          int32_t max_dist_x, int32_t max_dist_y, int32_t bw,
                          float cg, float cs, int is_cdna, int n_seg) {
    constexpr int32_t kMin = INT32_MIN;
    int32_t dq = (int32_t)ayi - (int32_t)ayj;
    int32_t sidi = (int32_t)((ayi >> 48) & 0xFF), sidj = (int32_t)((ayj >> 48) & 0xFF);
    if (dq <= 0 || dq > max_dist_x) return kMin;
    int32_t dr = (int32_t)(axi - axj);
    bool same = sidi == sidj;
    if (same && (dr == 0 || dq > max_dist_y)) return kMin;
    int32_t dd = dr > dq ? dr - dq : dq - dr;
    if (same && dd > bw) return kMin;
    if (n_seg > 1 && !is_cdna && same && dr > max_dist_y) return kMin;
    int32_t dg = dr < dq ? dr : dq;
    int32_t q_span = (int32_t)(ayj >> 32 & 0xFF);
    int32_t sc = q_span < dg ? q_span : dg;
    if (dd || dg > q_span) {
        float lin = cg * (float)dd + cs * (float)dg;
        float lg = dd >= 1 ? fast_log2f((float)(dd + 1)) : 0.0f;
        if (is_cdna || !same) {
            if (!same && dr == 0) ++sc;
            else if (dr > dq || !same) sc -= (int)(lin < lg ? lin : lg);
            else sc -= (int)(lin + 0.5f * lg);
        } else {
            sc -= (int)(lin + 0.5f * lg);
        }
    }
    return sc;
}

}  // namespace

int64_t mmt_chain_dp(const uint64_t* ax, const uint64_t* ay, int64_t n,
                     int max_dist_x, int max_dist_y, int bw, int max_skip,
                     int max_iter, float cg, float cs, int is_cdna, int n_seg,
                     int32_t* f, int64_t* p) {
    (void)max_skip;  // infinity semantics (the byte-match contract)
    int64_t st = 0, max_ii = -1;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t xi = ax[i];
        int32_t q_span = (int32_t)(ay[i] >> 32 & 0xFF);
        int32_t max_f = q_span;
        int64_t max_j = -1;
        while (st < i && ((xi >> 32) != (ax[st] >> 32) || xi > ax[st] + (uint64_t)max_dist_x))
            ++st;
        int64_t st2 = st;
        if (i - st2 > max_iter) st2 = i - max_iter;
        for (int64_t j = i - 1; j >= st2; --j) {
            int32_t sc = pair_score(xi, ay[i], ax[j], ay[j], max_dist_x,
                                    max_dist_y, bw, cg, cs, is_cdna, n_seg);
            if (sc == INT32_MIN) continue;
            sc += f[j];
            if (sc > max_f) { max_f = sc; max_j = j; }
        }
        int64_t end_j = st2 - 1;
        if (max_ii < 0 || xi - ax[max_ii] > (uint64_t)max_dist_x) {
            int32_t mx = INT32_MIN;
            max_ii = -1;
            for (int64_t j = i - 1; j >= st2; --j)
                if (mx < f[j]) { mx = f[j]; max_ii = j; }
        }
        if (max_ii >= 0 && max_ii < end_j) {
            int32_t tmp = pair_score(xi, ay[i], ax[max_ii], ay[max_ii],
                                     max_dist_x, max_dist_y, bw, cg, cs,
                                     is_cdna, n_seg);
            if (tmp != INT32_MIN && max_f < tmp + f[max_ii]) {
                max_f = tmp + f[max_ii];
                max_j = max_ii;
            }
        }
        f[i] = max_f;
        p[i] = max_j;
        if (max_ii < 0 || (xi - ax[max_ii] <= (uint64_t)max_dist_x && f[max_ii] < f[i]))
            max_ii = i;
    }
    return n;
}

// Bucketed point lookup over the sorted unique-minimizer table
// (mm_idx_get analog, index.c:81-98).  bucket_off[b] is the first uniq
// row whose (hash >> shift) >= b, with a trailing n_uniq sentinel; the
// per-query binary search runs inside one bucket (~tens of rows), so it
// stays cache-resident — ~20x the throughput of a full-table
// np.searchsorted pair.
void mmt_idx_lookup(const uint64_t* uniq, const int64_t* start,
                    const int64_t* cnt, int64_t n_uniq,
                    const int64_t* bucket_off, int64_t n_buckets, int shift,
                    const uint64_t* q, int64_t nq,
                    int64_t* lo_out, int64_t* cnt_out) {
    for (int64_t i = 0; i < nq; ++i) {
        uint64_t key = q[i];
        int64_t b = (int64_t)(key >> shift);
        int64_t lo, hi;
        if (b >= n_buckets) {
            lo = hi = n_uniq;
        } else {
            lo = bucket_off[b];
            hi = bucket_off[b + 1];
        }
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (uniq[mid] < key) lo = mid + 1;
            else hi = mid;
        }
        if (lo < n_uniq && uniq[lo] == key) {
            lo_out[i] = start[lo];
            cnt_out[i] = cnt[lo];
        } else {
            lo_out[i] = 0;
            cnt_out[i] = 0;
        }
    }
}

// Successor-range selection (plrange.cu:38-76 analog; semantics of
// chain_tpu.compute_ranges): rng[i] = #successors j>i in the same
// (read, strand, rid) group with rpos_j <= rpos_i + max_dist, capped at
// max_iter.  Positions ascend within a group, so a two-pointer scan is
// O(n) — replaces two O(n log n) cache-hostile searchsorted passes.
void mmt_compute_ranges(const uint64_t* ax, int64_t n,
                        const int64_t* bounds, int64_t n_bounds,
                        int64_t max_dist, int64_t max_iter,
                        int32_t* rng) {
    if (n == 0) return;
    std::vector<int64_t> starts;  // group start offsets (sorted)
    starts.reserve(1024);
    int64_t bi = 0;
    for (int64_t i = 0; i < n; ++i) {
        bool is_start = i == 0 || (ax[i] >> 32) != (ax[i - 1] >> 32);
        while (bi < n_bounds && bounds[bi] <= i) {
            if (bounds[bi] == i) is_start = true;
            ++bi;
        }
        if (is_start) starts.push_back(i);
    }
    starts.push_back(n);
    for (size_t g = 0; g + 1 < starts.size(); ++g) {
        int64_t s = starts[g], e = starts[g + 1];
        int64_t j = s;
        for (int64_t i = s; i < e; ++i) {
            uint64_t lim = (ax[i] & 0xFFFFFFFFULL) + (uint64_t)max_dist;
            if (j < i + 1) j = i + 1;
            while (j < e && (ax[j] & 0xFFFFFFFFULL) <= lim) ++j;
            int64_t r = j - i - 1;
            rng[i] = (int32_t)(r < max_iter ? r : max_iter);
        }
    }
}

// Packed-layout helpers for the chain kernel (chain_tpu.pack_class_meta):
// per-row range max (np.maximum.at is pathologically slow) and the
// per-tile dynamic window starts (first padded row whose range reaches
// into the tile).
void mmt_scatter_max(int32_t* out, const int64_t* rows,
                     const int32_t* vals, int64_t n) {
    for (int64_t i = 0; i < n; ++i)
        if (vals[i] > out[rows[i]]) out[rows[i]] = vals[i];
}

void mmt_tile_starts(const int32_t* rmax, int64_t H, int64_t W,
                     int64_t tile, int64_t n_tiles, int32_t* start) {
    for (int64_t i = 0; i < n_tiles; ++i) {
        int64_t t0 = i * tile;
        int64_t hi = t0 + W + tile - 1;
        if (hi > H) hi = H;
        int32_t ans = (int32_t)(W + tile - 1);
        for (int64_t r = t0; r < hi; ++r) {
            int64_t reach = r + (rmax[r] < W ? rmax[r] : W);
            if (reach >= t0 + W) { ans = (int32_t)(r - t0); break; }
        }
        start[i] = ans;
    }
}

// LPT lane packing for the device chain kernel's [rows, lanes] layout
// (chain_tpu._pack_lanes): longest segment first onto the currently
// shortest lane; ties broken by lane index (== Python heapq (h, lane)
// tuple order, so packings are bit-identical to the Python fallback).
void mmt_lpt_pack(const int64_t* lens, int64_t n, int64_t lanes,
                  int64_t* lane_of, int64_t* off_of, int64_t* height_out) {
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) { return lens[a] > lens[b]; });
    // binary min-heap over (height, lane)
    std::vector<std::pair<int64_t, int64_t>> heap(lanes);
    for (int64_t l = 0; l < lanes; ++l) heap[l] = {0, l};
    auto cmp = [](const std::pair<int64_t, int64_t>& a,
                  const std::pair<int64_t, int64_t>& b) { return a > b; };
    std::make_heap(heap.begin(), heap.end(), cmp);
    for (int64_t k = 0; k < n; ++k) {
        int64_t si = order[k];
        std::pop_heap(heap.begin(), heap.end(), cmp);
        auto [h, lane] = heap.back();
        lane_of[si] = lane;
        off_of[si] = h;
        heap.back() = {h + lens[si], lane};
        std::push_heap(heap.begin(), heap.end(), cmp);
    }
    int64_t hmax = 0;
    for (auto& e : heap) hmax = std::max(hmax, e.first);
    *height_out = hmax;
}

// Fused per-class operand pack for the 10 B/anchor flat uplink
// (chain_tpu.dispatch_scores): x/y stay int32, rng narrows to int16
// (in-class ranges are <= the window class <= 5120), and the scatter
// coordinate row is DROPPED — the device derives rows/cols from the
// per-segment metadata the Python side appends to the same flat buffer.
void mmt_pack_class_flat(const int64_t* cuts, const int64_t* sel,
                         int64_t n_sel, const int64_t* off_of,
                         const int32_t* x32, const int32_t* y32,
                         const int32_t* rng, int64_t W,
                         int32_t* fx, int32_t* fy, int16_t* fr,
                         int64_t* src_out, int32_t* rmax,
                         int64_t* pairs_out) {
    int64_t m = 0;
    int64_t pairs = 0;
    for (int64_t k = 0; k < n_sel; ++k) {
        const int64_t si = sel[k];
        const int64_t g0 = cuts[si], g1 = cuts[si + 1];
        const int64_t row0 = W + off_of[k];
        for (int64_t g = g0; g < g1; ++g, ++m) {
            const int64_t row = row0 + (g - g0);
            const int32_t r = rng[g];
            fx[m] = x32[g];
            fy[m] = y32[g];
            fr[m] = (int16_t)r;
            src_out[m] = g;
            if (r > rmax[row]) rmax[row] = r;
            pairs += r;
        }
    }
    *pairs_out = pairs;
}

// Fill-plan window checks (ksw2_tpu.plan_fill_light fast path): for each
// (qlen, tlen, w) fill, decide drop (empty band window / band-width
// overflow / rebase-step violation) and the true row count — the exact
// scalar form of _row_params + the per-block base validation.  C's >>
// on a negative int64 is an arithmetic shift (floor), matching numpy.
void mmt_fill_check(const int64_t* qlen, const int64_t* tlen,
                    const int64_t* w, int64_t n, int64_t Wband,
                    uint8_t* dropped, int64_t* r_true_out) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t ql = qlen[i], tl = tlen[i], wv = w[i];
        int64_t rt = ql + tl - 1;
        uint8_t drop = 0;
        int64_t base = 0, prev_base = -1;
        for (int64_t r = 0; r < rt; ++r) {
            int64_t st0 = 0;
            if (r - ql + 1 > st0) st0 = r - ql + 1;
            const int64_t t1 = (r - wv + 1) >> 1;
            if (t1 > st0) st0 = t1;
            int64_t en0 = tl - 1;
            if (r < en0) en0 = r;
            const int64_t t2 = (r + wv) >> 1;
            if (t2 < en0) en0 = t2;
            if (st0 > en0) {    // first empty window truncates r_true
                drop = 1;
                rt = r;
                break;
            }
            if ((r & 31) == 0) {
                int64_t b = st0 / 16 * 16 - 16;
                if (b < 0) b = 0;
                if (prev_base >= 0 && (b - prev_base > 48 || b < prev_base))
                    drop = 1;   // rebase step violation (defensive)
                prev_base = b;
                base = b;
            }
            const int64_t en = (en0 + 16) / 16 * 16 - 1;
            if (en - base >= Wband) drop = 1;  // band-width overflow
        }
        dropped[i] = drop;
        r_true_out[i] = rt;
    }
}

// Query-side occurrence filter (mm_seed_mz_flt, seed.c:5-28): drop
// minimizers whose within-read hash count exceeds both q_occ_max and
// n * q_occ_frac.  Order-preserving keep mask; replaces a per-read
// np.unique(return_inverse+counts) sort.
void mmt_seed_mz_flt(const uint64_t* keys, int64_t n, int64_t q_occ_max,
                     double q_occ_frac, uint8_t* keep) {
    std::unordered_map<uint64_t, int64_t> cnt;
    cnt.reserve((size_t)n * 2);
    for (int64_t i = 0; i < n; ++i) ++cnt[keys[i]];
    const double thr = (double)n * q_occ_frac;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t c = cnt[keys[i]];
        keep[i] = !(c > q_occ_max && (double)c > thr);
    }
}

// Fused anchor collection for the DEFAULT seeding path (no ava-mode
// skip_seed, no strand restriction, no qstrand): expands each kept
// seed's index occurrences into the (ax, ay) anchor encoding
// (collect_seed_hits, map.c:295-331) and applies the reference's
// unstable MSD radix permutation in one pass.  The numpy route stays
// for the flagged modes (ops/seed.py::collect_seed_hits).
int64_t mmt_collect_anchors(const uint64_t* occ_pos,
                            const int64_t* start, const int64_t* cnt,
                            const uint32_t* q_pos, const int32_t* q_span,
                            const int32_t* seg_id, const uint8_t* tandem,
                            int64_t n_seeds, int64_t qlen, int64_t n_hits,
                            uint64_t* ax_out, uint64_t* ay_out) {
    if (n_hits <= 0) return 0;
    std::vector<uint64_t> ax((size_t)n_hits), ay((size_t)n_hits);
    int64_t m = 0;
    for (int64_t s = 0; s < n_seeds; ++s) {
        const uint64_t qp = q_pos[s];
        const uint64_t span = (uint64_t)q_span[s];
        const uint64_t ybase = (span << 32)
            | ((uint64_t)(uint32_t)seg_id[s] << 48)
            | (tandem[s] ? (1ULL << 42) : 0ULL);
        const uint64_t y_fwd = ybase | (qp >> 1);
        const uint64_t y_rev = ybase
            | ((uint64_t)qlen - ((qp >> 1) + 1 - span) - 1);
        const uint64_t* occ = occ_pos + start[s];
        const int64_t c = cnt[s];
        for (int64_t j = 0; j < c; ++j, ++m) {
            const uint64_t r = occ[j];
            const uint64_t rpos = (r & 0xFFFFFFFFULL) >> 1;
            const uint64_t rid_hi = r & 0xFFFFFFFF00000000ULL;
            if ((r & 1) == (qp & 1)) {
                ax[m] = rid_hi | rpos;
                ay[m] = y_fwd;
            } else {
                ax[m] = (1ULL << 63) | rid_hi | rpos;
                ay[m] = y_rev;
            }
        }
    }
    std::vector<int64_t> perm((size_t)m);
    mmt_radix_perm64(ax.data(), m, perm.data());
    for (int64_t i = 0; i < m; ++i) {
        ax_out[i] = ax[(size_t)perm[i]];
        ay_out[i] = ay[(size_t)perm[i]];
    }
    return m;
}

}  // extern "C"
