// alignkit.cpp — native per-region alignment driver (mm_align1 analog).
//
// Byte-exact C++ port of ops/align.py::_align1 for the non-splice,
// non-qstrand, non-debug host path (the reference's align.c:573-826
// orchestration: end trimming, bad-seed filtering, left/right extension,
// per-gap filling with Z-drop, CIGAR fixing and identity statistics).
// The DP kernels are the byte-exact ksw2kit functions, called in-process
// — this removes the ~150k-per-flowcell Python/ctypes round trips that
// made the host finish stage 2-3x slower than the reference binary.
//
// The Python _align1 remains the oracle; tests/test_align_native.py
// cross-checks the two on random + golden workloads, and the e2e
// goldens/fuzzer gate the whole path.  Z-drop splits are reported back
// (split_n/zdrop_code) so Python performs mm_split_reg with its exact
// float32 staging (models/hit.py::split_reg).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {
int64_t mmt_ksw_extz2(const uint8_t *qseq, int32_t qlen, const uint8_t *tseq,
                      int32_t tlen, const int8_t *mat, int32_t m, int32_t q,
                      int32_t e, int32_t w, int32_t zdrop, int32_t end_bonus,
                      int32_t flag, int32_t *ez_out, uint32_t *cigar_out,
                      int64_t cigar_cap);
int64_t mmt_ksw_extd2(const uint8_t *qseq, int32_t qlen, const uint8_t *tseq,
                      int32_t tlen, const int8_t *mat, int32_t m, int32_t q,
                      int32_t e, int32_t q2, int32_t e2, int32_t w,
                      int32_t zdrop, int32_t end_bonus, int32_t flag,
                      int32_t *ez_out, uint32_t *cigar_out, int64_t cigar_cap);
int32_t mmt_test_zdrop(const uint8_t *qseq, const uint8_t *tseq,
                       const uint32_t *cigar, int64_t n_cigar,
                       const int8_t *mat, int32_t q, int32_t e,
                       int32_t zdrop, int32_t zdrop_inv, int32_t max_gap,
                       int32_t try_inv, int32_t min_sc, int32_t min_dp_max);
}

namespace {

constexpr int32_t KSW_NEG_INF = -0x40000000;
constexpr int32_t EZ_RIGHT = 0x02;
constexpr int32_t EZ_APPROX_MAX = 0x08;
constexpr int32_t EZ_EXTZ_ONLY = 0x40;
constexpr int32_t EZ_REV_CIGAR = 0x80;

constexpr uint64_t SEED_LONG_JOIN = 1ull << 40;
constexpr uint64_t SEED_IGNORE = 1ull << 41;
constexpr uint64_t SEED_TANDEM = 1ull << 42;
constexpr uint64_t SEED_SELF = 1ull << 43;

constexpr uint32_t OP_M = 0, OP_I = 1, OP_D = 2, OP_N = 3;
constexpr uint32_t OP_EQ = 7, OP_X = 8;

inline int64_t lo32(uint64_t v) { return (int64_t)(uint32_t)v; }
inline int64_t span_of(uint64_t ayv) { return (int64_t)((ayv >> 32) & 0xFF); }

// mg_log2 (mmpriv.h:118-126) with the Python oracle's exact float32
// staging (ops/align.py::_mg_log2).  Baseline x86-64 has no scalar FMA,
// so -O3 cannot contract the f32 mul+add below.
inline float mg_log2f(double x_in) {
    float xf = (float)x_in;
    uint32_t zi;
    std::memcpy(&zi, &xf, 4);
    float log_2 = (float)((int)((zi >> 23) & 255) - 128);
    zi = (zi & ~(255u << 23)) + (127u << 23);
    float zf;
    std::memcpy(&zf, &zi, 4);
    double f = (double)zf;
    float t32 = (float)((float)(-0.34484843f * zf) + 2.02466578f);
    double log2d = (double)log_2 + ((double)t32 * f - 0.67487759);
    return (float)log2d;
}

struct EzC {
    int32_t score = KSW_NEG_INF;
    int32_t max = 0;
    int32_t max_q = -1, max_t = -1;
    int32_t mqe = KSW_NEG_INF, mqe_t = -1;
    int32_t mte = KSW_NEG_INF, mte_q = -1;
    int32_t zdropped = 0, reach_end = 0;
    std::vector<uint32_t> cig;
};

struct Opt {
    int64_t a, b, q, e, q2, e2, zdrop, zdrop_inv, end_bonus, max_gap;
    int64_t min_cnt, min_ksw_len, min_chain_score, min_dp_max;
    int64_t bw, bw_long;      // pre-scaled: int(opt.bw*1.5+1) etc.
    int64_t bw_raw;           // opt.bw as-is (fix_bad_ends)
    int64_t max_sw_mat;
    bool is_sr, no_end_flt, is_eqx, try_inv, is_hpc, log_gap;
    int64_t k;
};

// ---------------------------------------------------------------------
// fill session — the TPU speculative-batching hooks (the C-speed analog
// of ops/align.py's _fill_collect/_fill_cache globals).  Mode 1
// (collect): every APPROX_MAX gap fill is recorded and answered with
// the same fake ez the Python collect pass uses; mode 2 (table): fills
// are answered from the device-computed result table, any miss computes
// locally (byte-exact either way).  Collect runs single-threaded
// (pipeline._prefill_device); the table is read-only during the
// (possibly threaded) real pass.
struct FillSession {
    int mode = 0;
    std::vector<int64_t> meta;          // 4 per fill: ql, tl, w, zdrop
    std::vector<uint8_t> qblob, tblob;
    std::unordered_map<std::string, size_t> table;
    std::vector<int32_t> t_score;
    std::vector<uint32_t> t_cig_blob;
    std::vector<int64_t> t_cig_off;     // n+1 offsets into t_cig_blob
};
FillSession g_fill;

std::string fill_key(const uint8_t *q, int64_t ql, const uint8_t *t,
                     int64_t tl, int64_t w, int64_t zdrop) {
    std::string k;
    k.reserve((size_t)(ql + tl) + 32);
    int64_t hdr[4] = {ql, tl, w, zdrop};
    k.append((const char *)hdr, sizeof hdr);
    k.append((const char *)q, (size_t)ql);
    k.append((const char *)t, (size_t)tl);
    return k;
}

// mm_align_pair (align.c:316-342) for the non-splice path
void align_pair_c(const Opt &o, const uint8_t *q, int64_t ql,
                  const uint8_t *t, int64_t tl, const int8_t *mat,
                  int64_t w, int64_t end_bonus, int64_t zdrop, int32_t flag,
                  EzC &ez) {
    ez = EzC{};
    if (o.max_sw_mat > 0 && tl * ql > o.max_sw_mat) {
        ez.zdropped = 1;
        return;
    }
    // fill-session hook: same eligibility as ops/align.py::_align_pair
    // ("fill" kind) — APPROX_MAX exactly, both sides non-empty, dual
    // gap costs in play
    if (g_fill.mode != 0 && flag == EZ_APPROX_MAX && ql > 0 && tl > 0
        && !(o.q == o.q2 && o.e == o.e2)) {
        if (g_fill.mode == 1) {         // collect + fake (align._fake_ez)
            int64_t m4[4] = {ql, tl, w, zdrop};
            g_fill.meta.insert(g_fill.meta.end(), m4, m4 + 4);
            g_fill.qblob.insert(g_fill.qblob.end(), q, q + ql);
            g_fill.tblob.insert(g_fill.tblob.end(), t, t + tl);
            ez.score = 0;
            ez.max = 0;
            ez.max_q = (int32_t)(ql - 1);
            ez.max_t = (int32_t)(tl - 1);
            // Fake must CONSUME both sequences exactly: the epilogue's
            // cigar-extent consistency check (qoff/toff vs the region
            // coordinates) otherwise declines the whole region with -2
            // and the Python oracle redoes it — measured 5x the collect
            // pass on a flowcell.  Outputs of the collect pass are
            // discarded, so the op content is free as long as lengths
            // add up.
            ez.cig.assign(1, (uint32_t)(std::min(ql, tl) << 4) | OP_M);
            if (ql > tl)
                ez.cig.push_back((uint32_t)((ql - tl) << 4) | OP_I);
            else if (tl > ql)
                ez.cig.push_back((uint32_t)((tl - ql) << 4) | OP_D);
            return;
        }
        auto it = g_fill.table.find(fill_key(q, ql, t, tl, w, zdrop));
        if (it != g_fill.table.end()) {
            const size_t i = it->second;
            ez.score = g_fill.t_score[i];
            ez.cig.assign(
                g_fill.t_cig_blob.begin() + g_fill.t_cig_off[i],
                g_fill.t_cig_blob.begin() + g_fill.t_cig_off[i + 1]);
            return;
        }                               // miss: local kernel below
    }
    int32_t out[10];
    std::vector<uint32_t> buf(ql + tl + 4);
    int64_t n;
    if (o.q == o.q2 && o.e == o.e2)
        n = mmt_ksw_extz2(q, (int32_t)ql, t, (int32_t)tl, mat, 5,
                          (int32_t)o.q, (int32_t)o.e, (int32_t)w,
                          (int32_t)zdrop, (int32_t)end_bonus, flag, out,
                          buf.data(), (int64_t)buf.size());
    else
        n = mmt_ksw_extd2(q, (int32_t)ql, t, (int32_t)tl, mat, 5,
                          (int32_t)o.q, (int32_t)o.e, (int32_t)o.q2,
                          (int32_t)o.e2, (int32_t)w, (int32_t)zdrop,
                          (int32_t)end_bonus, flag, out, buf.data(),
                          (int64_t)buf.size());
    if (n < 0) n = 0;  // capacity bound above is provably sufficient
    ez.score = out[0]; ez.max = out[1]; ez.max_q = out[2];
    ez.max_t = out[3]; ez.mqe = out[4]; ez.mqe_t = out[5];
    ez.mte = out[6]; ez.mte_q = out[7]; ez.zdropped = out[8];
    ez.reach_end = out[9];
    ez.cig.assign(buf.begin(), buf.begin() + n);
}

// mm_append_cigar (align.c:291-314)
void append_cigar(std::vector<uint32_t> &c, const std::vector<uint32_t> &add) {
    if (add.empty()) return;
    size_t i = 0;
    if (!c.empty() && (c.back() & 0xF) == (add[0] & 0xF)) {
        c.back() += (add[0] >> 4) << 4;
        i = 1;
    }
    c.insert(c.end(), add.begin() + i, add.end());
}

// collect_long_gaps (align.c:370-387); empty result == "None"
std::vector<int64_t> collect_long_gaps(int64_t as1, int64_t cnt1,
                                       const uint64_t *ax, const uint64_t *ay,
                                       int64_t min_gap) {
    std::vector<int64_t> K;
    if (cnt1 < 2) return K;
    for (int64_t i = 1; i < cnt1; ++i) {
        int64_t gap = (lo32(ay[as1 + i]) - lo32(ay[as1 + i - 1]))
                      - (lo32(ax[as1 + i]) - lo32(ax[as1 + i - 1]));
        if (gap > min_gap || gap < -min_gap) K.push_back(i);
    }
    if (K.size() <= 1) K.clear();
    return K;
}

// mm_filter_bad_seeds (align.c:389-424)
void filter_bad_seeds(int64_t as1, int64_t cnt1, const uint64_t *ax,
                      uint64_t *ay, int64_t min_gap, int64_t diff_thres,
                      int64_t max_ext_len, int64_t max_ext_cnt) {
    auto K = collect_long_gaps(as1, cnt1, ax, ay, min_gap);
    if (K.empty()) return;
    int64_t n = (int64_t)K.size();
    int64_t mx = 0, max_st = -1, max_en = -1;
    int64_t k = 0;
    while (true) {
        if (k == n || k >= max_en) {
            if (max_en > 0)
                for (int64_t i = K[max_st]; i < K[max_en]; ++i)
                    ay[as1 + i] |= SEED_IGNORE;
            mx = 0; max_st = -1; max_en = -1;
            if (k == n) break;
        }
        int64_t i = K[k];
        int64_t gap = (lo32(ay[as1 + i]) - lo32(ay[as1 + i - 1]))
                      - (lo32(ax[as1 + i]) - lo32(ax[as1 + i - 1]));
        int64_t n_ins = gap > 0 ? gap : 0;
        int64_t n_del = gap <= 0 ? -gap : 0;
        int64_t qs = lo32(ay[as1 + i - 1]);
        int64_t rs = lo32(ax[as1 + i - 1]);
        int64_t max_diff = 0, max_diff_l = -1;
        for (int64_t l = k + 1; l < n && l <= k + max_ext_cnt; ++l) {
            int64_t j = K[l];
            if (lo32(ay[as1 + j]) - qs > max_ext_len
                || lo32(ax[as1 + j]) - rs > max_ext_len)
                break;
            gap = (lo32(ay[as1 + j]) - lo32(ay[as1 + j - 1]))
                  - (lo32(ax[as1 + j]) - lo32(ax[as1 + j - 1]));
            if (gap > 0) n_ins += gap; else n_del += -gap;
            int64_t d = n_ins - n_del;
            int64_t diff = n_ins + n_del - (d > 0 ? d : -d);
            if (max_diff < diff) { max_diff = diff; max_diff_l = l; }
        }
        if (max_diff > diff_thres && max_diff > mx) {
            mx = max_diff; max_st = k; max_en = max_diff_l;
        }
        ++k;
    }
}

// mm_filter_bad_seeds_alt (align.c:426-460)
void filter_bad_seeds_alt(int64_t as1, int64_t cnt1, const uint64_t *ax,
                          uint64_t *ay, int64_t min_gap, int64_t max_ext) {
    auto K = collect_long_gaps(as1, cnt1, ax, ay, min_gap);
    if (K.empty()) return;
    int64_t n = (int64_t)K.size();
    int64_t k = 0;
    while (k < n) {
        int64_t i = K[k];
        int64_t gap1 = (lo32(ay[as1 + i]) - lo32(ay[as1 + i - 1]))
                       - (lo32(ax[as1 + i]) - lo32(ax[as1 + i - 1]));
        int64_t re1 = lo32(ax[as1 + i]);
        int64_t qe1 = lo32(ay[as1 + i]);
        gap1 = gap1 > 0 ? gap1 : -gap1;
        int64_t l = k + 1;
        while (l < n) {
            int64_t j = K[l];
            if (lo32(ay[as1 + j]) - qe1 > max_ext
                || lo32(ax[as1 + j]) - re1 > max_ext)
                break;
            int64_t gap2 = (lo32(ay[as1 + j]) - lo32(ay[as1 + j - 1]))
                           - (lo32(ax[as1 + j]) - lo32(ax[as1 + j - 1]));
            int64_t q_span_pre = span_of(ay[as1 + j - 1]);
            int64_t rs2 = lo32(ax[as1 + j - 1]) + q_span_pre;
            int64_t qs2 = lo32(ay[as1 + j - 1]) + q_span_pre;
            int64_t m = rs2 - re1 < qs2 - qe1 ? rs2 - re1 : qs2 - qe1;
            gap2 = gap2 > 0 ? gap2 : -gap2;
            if (m > gap1 + gap2) break;
            re1 = lo32(ax[as1 + j]);
            qe1 = lo32(ay[as1 + j]);
            gap1 = gap2;
            ++l;
        }
        if (l > k + 1) {
            int64_t end = K[l - 1];
            for (int64_t j = K[k]; j < end; ++j) ay[as1 + j] |= SEED_IGNORE;
            ay[as1 + end] |= SEED_LONG_JOIN;
        }
        k = l;
    }
}

// mm_fix_bad_ends (align.c:462-496)
void fix_bad_ends(int64_t r_as, int64_t r_cnt, int64_t r_mlen,
                  const uint64_t *ax, const uint64_t *ay, int64_t bw,
                  int64_t min_match, int64_t &as_out, int64_t &cnt_out) {
    as_out = r_as; cnt_out = r_cnt;
    if (r_cnt < 3) return;
    int64_t m = span_of(ay[r_as]), l = m;
    int64_t as_ = r_as;
    for (int64_t i = r_as + 1; i < r_as + r_cnt - 1; ++i) {
        int64_t q_span = span_of(ay[i]);
        if (ay[i] & SEED_LONG_JOIN) break;
        int64_t lr = lo32(ax[i]) - lo32(ax[i - 1]);
        int64_t lq = lo32(ay[i]) - lo32(ay[i - 1]);
        int64_t mn = lr < lq ? lr : lq, mxv = lr < lq ? lq : lr;
        if (mxv - mn > (l >> 1)) as_ = i;
        l += mn;
        m += mn < q_span ? mn : q_span;
        if (l >= bw << 1 || (m >= min_match && m >= bw)
            || m >= (r_mlen >> 1))
            break;
    }
    int64_t cnt = r_as + r_cnt - as_;
    m = l = span_of(ay[r_as + r_cnt - 1]);
    for (int64_t i = r_as + r_cnt - 2; i > as_; --i) {
        int64_t q_span = span_of(ay[i + 1]);
        if (ay[i + 1] & SEED_LONG_JOIN) break;
        int64_t lr = lo32(ax[i + 1]) - lo32(ax[i]);
        int64_t lq = lo32(ay[i + 1]) - lo32(ay[i]);
        int64_t mn = lr < lq ? lr : lq, mxv = lr < lq ? lq : lr;
        if (mxv - mn > (l >> 1)) cnt = i + 1 - as_;
        l += mn;
        m += mn < q_span ? mn : q_span;
        if (l >= bw << 1 || (m >= min_match && m >= bw)
            || m >= (r_mlen >> 1))
            break;
    }
    as_out = as_; cnt_out = cnt;
}

// mm_max_stretch (align.c:498-524)
void max_stretch(int64_t r_as, int64_t r_cnt, const uint64_t *ax,
                 const uint64_t *ay, int64_t &as_out, int64_t &cnt_out) {
    as_out = r_as; cnt_out = r_cnt;
    if (r_cnt < 2) return;
    int64_t max_score = -1, max_i = -1, max_len = 0;
    int64_t score = span_of(ay[r_as]), length = 1;
    int64_t i = r_as + 1;
    for (; i < r_as + r_cnt; ++i) {
        int64_t q_span = span_of(ay[i]);
        int64_t lr = lo32(ax[i]) - lo32(ax[i - 1]);
        int64_t lq = lo32(ay[i]) - lo32(ay[i - 1]);
        if (lq == lr) {
            score += lq < q_span ? lq : q_span;
            ++length;
        } else {
            if (score > max_score) {
                max_score = score; max_len = length; max_i = i - length;
            }
            score = q_span; length = 1;
        }
    }
    if (score > max_score) {
        max_score = score; max_len = length; max_i = i - length;
    }
    as_out = max_i; cnt_out = max_len;
}

// mm_adjust_minier (align.c:353-368), non-qstrand
void adjust_minier(bool is_hpc, int64_t k, const uint8_t *seq_codes,
                   const uint64_t *offsets, const uint8_t *fwd,
                   const uint8_t *rc, uint64_t axi, uint64_t ayi,
                   int64_t &r_out, int64_t &q_out) {
    if (is_hpc) {
        const uint8_t *qseq = (axi >> 63) ? rc : fwd;
        int64_t q = lo32(ayi);
        int c = qseq[q];
        int64_t i = q - 1;
        while (i > 0 && qseq[i] == c) --i;
        q_out = i + 1;
        int64_t rid = (int64_t)((axi << 1) >> 33);
        int64_t off0 = (int64_t)offsets[rid];
        int64_t off = off0 + lo32(axi);
        c = seq_codes[off];
        i = off - 1;
        while (i >= off0 && seq_codes[i] == c) --i;
        int64_t hp = off - i;  // _get_hplen_back
        r_out = lo32(axi) + 1 - hp;
    } else {
        r_out = lo32(axi) - (k >> 1);
        q_out = lo32(ayi) - (k >> 1);
    }
}

// mm_fix_cigar (align.c:91-167); returns false on walk-length mismatch
// (caller falls back to Python whose assert reports it)
bool fix_cigar(std::vector<uint32_t> &cig, const uint8_t *qseq,
               const uint8_t *tseq, int64_t want_q, int64_t want_t,
               int64_t &qshift, int64_t &tshift, uint32_t &lead_op,
               int64_t &lead_len) {
    qshift = tshift = 0;
    lead_op = 0xF; lead_len = 0;
    if (cig.size() <= 1) {
        // the Python oracle still asserts the walk on the 0/1-op path?
        // No: it returns before walking (align.py:560-561).
        return true;
    }
    int64_t toff = 0, qoff = 0;
    bool to_shrink = false;
    int64_t nc = (int64_t)cig.size();
    for (int64_t k = 0; k < nc; ++k) {
        uint32_t op = cig[k] & 0xF, ln = cig[k] >> 4;
        if (ln == 0) to_shrink = true;
        if (op == OP_M) {
            toff += ln; qoff += ln;
        } else if (op == OP_I || op == OP_D) {
            if (k > 0 && k < nc - 1 && (cig[k - 1] & 0xF) == OP_M
                && (cig[k + 1] & 0xF) == OP_M) {
                int64_t prev_len = cig[k - 1] >> 4;
                int64_t l = 0;
                if (op == OP_I) {
                    while (l < prev_len
                           && qseq[qoff - 1 - l] == qseq[qoff + ln - 1 - l])
                        ++l;
                } else {
                    while (l < prev_len
                           && tseq[toff - 1 - l] == tseq[toff + ln - 1 - l])
                        ++l;
                }
                if (l > 0) {
                    cig[k - 1] -= (uint32_t)(l << 4);
                    cig[k + 1] += (uint32_t)(l << 4);
                    qoff -= l; toff -= l;
                }
                if (l == prev_len) to_shrink = true;
            }
            if (op == OP_I) qoff += ln; else toff += ln;
        } else if (op == OP_N) {
            toff += ln;
        }
    }
    if (qoff != want_q || toff != want_t) return false;
    int64_t k = 0;
    while (k < (int64_t)cig.size() - 2) {
        if ((cig[k] & 0xF) > 0
            && (cig[k] & 0xF) + (cig[k + 1] & 0xF) == 3) {
            int64_t s1 = 0, s2 = 0;
            int64_t l = k;
            for (; l < (int64_t)cig.size(); ++l) {
                uint32_t op = cig[l] & 0xF;
                if (op == OP_I) s1 += cig[l] >> 4;
                else if (op == OP_D) s2 += cig[l] >> 4;
                else if ((cig[l] >> 4) != 0) break;
            }
            if (s1 > 0 && s2 > 0 && l - k > 2) {
                cig[k] = (uint32_t)(s1 << 4) | OP_I;
                cig[k + 1] = (uint32_t)(s2 << 4) | OP_D;
                for (int64_t kk = k + 2; kk < l; ++kk) cig[kk] &= 0xF;
                to_shrink = true;
            }
            k = l + 1;
        } else {
            ++k;
        }
    }
    if (to_shrink) {
        std::vector<uint32_t> cig2;
        for (uint32_t c : cig) if ((c >> 4) != 0) cig2.push_back(c);
        std::vector<uint32_t> out;
        for (size_t k2 = 0; k2 < cig2.size(); ++k2) {
            if (k2 == cig2.size() - 1
                || (cig2[k2] & 0xF) != (cig2[k2 + 1] & 0xF))
                out.push_back(cig2[k2]);
            else
                cig2[k2 + 1] += (cig2[k2] >> 4) << 4;
        }
        cig.swap(out);
    }
    if (!cig.empty()
        && ((cig[0] & 0xF) == OP_I || (cig[0] & 0xF) == OP_D)) {
        lead_op = cig[0] & 0xF;
        lead_len = cig[0] >> 4;
        if (lead_op == OP_I) qshift = lead_len; else tshift = lead_len;
        cig.erase(cig.begin());
    }
    return true;
}

// mm_update_cigar_eqx (align.c:169-238)
void update_cigar_eqx(std::vector<uint32_t> &cig, const uint8_t *qseq,
                      const uint8_t *tseq) {
    std::vector<uint32_t> out;
    int64_t toff = 0, qoff = 0;
    for (uint32_t c : cig) {
        uint32_t op = c & 0xF;
        int64_t ln = c >> 4;
        if (op == OP_M) {
            while (ln > 0) {
                int64_t l = 0;
                while (l < ln && qseq[qoff + l] == tseq[toff + l]) ++l;
                if (l > 0) {
                    out.push_back((uint32_t)(l << 4) | OP_EQ);
                    ln -= l; toff += l; qoff += l;
                }
                l = 0;
                while (l < ln && qseq[qoff + l] != tseq[toff + l]) ++l;
                if (l > 0) {
                    out.push_back((uint32_t)(l << 4) | OP_X);
                    ln -= l; toff += l; qoff += l;
                }
            }
            continue;
        }
        if (op == OP_I) qoff += ln;
        else if (op == OP_D || op == OP_N) toff += ln;
        out.push_back(c);
    }
    cig.swap(out);
}

}  // namespace

// mmt_align1 — drive one region end to end.
//
// p[] (int64): 0 a, 1 b, 2 q, 3 e, 4 q2, 5 e2, 6 zdrop, 7 zdrop_inv,
//   8 end_bonus, 9 max_gap, 10 min_cnt, 11 min_ksw_len,
//   12 min_chain_score, 13 min_dp_max, 14 bw (pre-scaled 1.5x+1),
//   15 bw_long (pre-scaled), 16 bw_raw, 17 max_sw_mat, 18 is_sr,
//   19 no_end_flt, 20 is_eqx, 21 try_inv, 22 k, 23 is_hpc, 24 log_gap,
//   25 as0, 26 cnt0, 27 mlen0, 28 split_inv, 29 rs_in, 30 re_in,
//   31 qs_in, 32 qe_in, 33 qlen.
//
// out[] (int64): 0 have_p, 1 dp_score, 2 dp_max, 3 n_ambi, 4 blen,
//   5 mlen, 6 rs, 7 re, 8 qs, 9 qe, 10 split_n (0 = none),
//   11 zdrop_code.
//
// Returns n_cigar >= 0; -1 if cigar_cap too small (out[0] then holds the
// required size); -2 to request the Python fallback (semantic-violation
// guard, mirrors the oracle's asserts).
extern "C" int64_t mmt_align1(
    const uint64_t *ax, uint64_t *ay, int64_t n_a,
    const uint8_t *seq_codes, const uint64_t *offsets, const int64_t *lens,
    const uint8_t *fwd, const uint8_t *rc,
    const int8_t *mat, const int64_t *p, int64_t *out,
    uint32_t *cigar_out, int64_t cigar_cap) {
    Opt o;
    o.a = p[0]; o.b = p[1]; o.q = p[2]; o.e = p[3]; o.q2 = p[4];
    o.e2 = p[5]; o.zdrop = p[6]; o.zdrop_inv = p[7]; o.end_bonus = p[8];
    o.max_gap = p[9]; o.min_cnt = p[10]; o.min_ksw_len = p[11];
    o.min_chain_score = p[12]; o.min_dp_max = p[13]; o.bw = p[14];
    o.bw_long = p[15]; o.bw_raw = p[16]; o.max_sw_mat = p[17];
    o.is_sr = p[18] != 0; o.no_end_flt = p[19] != 0;
    o.is_eqx = p[20] != 0; o.try_inv = p[21] != 0; o.k = p[22];
    o.is_hpc = p[23] != 0; o.log_gap = p[24] != 0;
    const int64_t as0 = p[25], cnt0 = p[26], mlen0 = p[27];
    const bool split_inv_in = p[28] != 0;
    const int64_t r_rs = p[29], r_re = p[30], r_qs = p[31],
                  r_qe = p[32];
    const int64_t qlen = p[33];

    for (int i = 0; i < 12; ++i) out[i] = 0;
    if (cnt0 == 0) return 0;

    const int64_t rid = (int64_t)((ax[as0] << 1) >> 33);
    const int rev = (int)(ax[as0] >> 63);
    const int64_t rlen = lens[rid];
    const uint8_t *tbase = seq_codes + offsets[rid];
    const uint8_t *qstrand_qseq = rev ? rc : fwd;

    int64_t as1, cnt1;
    int64_t rs, qs, re, qe;
    if (o.is_sr && !o.is_hpc) {
        max_stretch(as0, cnt0, ax, ay, as1, cnt1);
        rs = lo32(ax[as1]) + 1 - span_of(ay[as1]);
        qs = lo32(ay[as1]) + 1 - span_of(ay[as1]);
        re = lo32(ax[as1 + cnt1 - 1]) + 1;
        qe = lo32(ay[as1 + cnt1 - 1]) + 1;
    } else {
        if (!o.no_end_flt)
            fix_bad_ends(as0, cnt0, mlen0, ax, ay, o.bw_raw,
                         o.min_chain_score * 2, as1, cnt1);
        else {
            as1 = as0; cnt1 = cnt0;
        }
        filter_bad_seeds(as1, cnt1, ax, ay, 10, 40, o.max_gap >> 1, 10);
        filter_bad_seeds_alt(as1, cnt1, ax, ay, 30, o.max_gap >> 1);
        adjust_minier(o.is_hpc, o.k, seq_codes, offsets, fwd, rc,
                      ax[as1], ay[as1], rs, qs);
        adjust_minier(o.is_hpc, o.k, seq_codes, offsets, fwd, rc,
                      ax[as1 + cnt1 - 1], ay[as1 + cnt1 - 1], re, qe);
    }
    if (cnt1 <= 0) return -2;

    // DP region bounds (align.c:618-694)
    int64_t rs0, qs0, re0, qe0;
    if (o.is_sr) {
        qs0 = 0; qe0 = qlen;
        int64_t l = qs;
        if (l * o.a + o.end_bonus > o.q)
            l += (l * o.a + o.end_bonus - o.q) / o.e;
        rs0 = rs - l > 0 ? rs - l : 0;
        l = qlen - qe;
        if (l * o.a + o.end_bonus > o.q)
            l += (l * o.a + o.end_bonus - o.q) / o.e;
        re0 = re + l < rlen ? re + l : rlen;
    } else {
        rs0 = lo32(ax[as0]) + 1 - span_of(ay[as0]);
        qs0 = lo32(ay[as0]) + 1 - span_of(ay[as0]);
        if (rs0 < 0) rs0 = 0;
        if (qs0 < 0) return -2;
        int64_t rs1_ = 0, qs1_ = 0, l = 0;
        for (int64_t i = as0 - 1;
             i >= 0 && (ax[i] >> 32) == (ax[as0] >> 32); --i) {
            int64_t x = lo32(ax[i]) + 1 - span_of(ay[i]);
            int64_t y = lo32(ay[i]) + 1 - span_of(ay[i]);
            if (x < rs0 && y < qs0) {
                if (++l > o.min_cnt) {
                    l = rs0 - x > qs0 - y ? rs0 - x : qs0 - y;
                    rs1_ = rs0 - l; qs1_ = qs0 - l;
                    if (rs1_ < 0) rs1_ = 0;
                    break;
                }
            }
        }
        if (qs > 0 && rs > 0) {
            l = qs < o.max_gap ? qs : o.max_gap;
            qs1_ = qs1_ > qs - l ? qs1_ : qs - l;
            qs0 = qs0 < qs1_ ? qs0 : qs1_;
            if (l * o.a > o.q) l += (l * o.a - o.q) / o.e;
            l = l < o.max_gap ? l : o.max_gap;
            l = l < rs ? l : rs;
            rs1_ = rs1_ > rs - l ? rs1_ : rs - l;
            rs0 = rs0 < rs1_ ? rs0 : rs1_;
            rs0 = rs0 < rs ? rs0 : rs;
        } else {
            rs0 = rs; qs0 = qs;
        }
        re0 = lo32(ax[as0 + cnt0 - 1]) + 1;
        qe0 = lo32(ay[as0 + cnt0 - 1]) + 1;
        int64_t re1_ = rlen, qe1_ = qlen;
        l = 0;
        for (int64_t i = as0 + cnt0;
             i < n_a && (ax[i] >> 32) == (ax[as0] >> 32); ++i) {
            int64_t x = lo32(ax[i]) + 1;
            int64_t y = lo32(ay[i]) + 1;
            if (x > re0 && y > qe0) {
                if (++l > o.min_cnt) {
                    l = x - re0 > y - qe0 ? x - re0 : y - qe0;
                    re1_ = re0 + l; qe1_ = qe0 + l;
                    break;
                }
            }
        }
        if (qe < qlen && re < rlen) {
            l = qlen - qe < o.max_gap ? qlen - qe : o.max_gap;
            qe1_ = qe1_ < qe + l ? qe1_ : qe + l;
            qe0 = qe0 > qe1_ ? qe0 : qe1_;
            if (l * o.a > o.q) l += (l * o.a - o.q) / o.e;
            l = l < o.max_gap ? l : o.max_gap;
            l = l < rlen - re ? l : rlen - re;
            re1_ = re1_ < re + l ? re1_ : re + l;
            re0 = re0 > re1_ ? re0 : re1_;
        } else {
            re0 = re; qe0 = qe;
        }
    }
    if (ay[as0] & SEED_SELF) {
        int64_t max_ext = r_qs - r_rs;
        if (max_ext < 0) max_ext = -max_ext;
        if (r_rs - rs0 > max_ext) rs0 = r_rs - max_ext;
        if (r_qs - qs0 > max_ext) qs0 = r_qs - max_ext;
        max_ext = r_qe - r_re;
        if (max_ext < 0) max_ext = -max_ext;
        if (re0 - r_re > max_ext) re0 = r_re + max_ext;
        if (qe0 - r_qe > max_ext) qe0 = r_qe + max_ext;
    }
    if (re0 <= rs0) return -2;

    bool have_p = false;
    std::vector<uint32_t> rcig;
    int64_t dp_score = 0;
    int64_t split_n = 0, split_code = 0;
    bool dropped = false;
    EzC ez;
    std::vector<uint8_t> qrev, trev;

    int64_t rs1, qs1, re1, qe1;
    if (qs > 0 && rs > 0) {  // left extension (align.c:700-720)
        qrev.assign(qstrand_qseq + qs0, qstrand_qseq + qs);
        std::reverse(qrev.begin(), qrev.end());
        trev.assign(tbase + rs0, tbase + rs);
        std::reverse(trev.begin(), trev.end());
        align_pair_c(o, qrev.data(), (int64_t)qrev.size(), trev.data(),
                     (int64_t)trev.size(), mat, o.bw, o.end_bonus,
                     split_inv_in ? o.zdrop_inv : o.zdrop,
                     EZ_EXTZ_ONLY | EZ_RIGHT | EZ_REV_CIGAR, ez);
        if (!ez.cig.empty()) {
            append_cigar(rcig, ez.cig);
            have_p = true;
            dp_score += ez.max;
        }
        rs1 = rs - (ez.reach_end ? ez.mqe_t + 1 : ez.max_t + 1);
        qs1 = qs - (ez.reach_end ? qs - qs0 : ez.max_q + 1);
    } else {
        rs1 = rs; qs1 = qs;
    }
    re1 = rs; qe1 = qs;
    if (qs1 < 0 || rs1 < 0) return -2;

    int64_t i = o.is_sr ? cnt1 - 1 : 1;
    while (i < cnt1) {  // gap filling (align.c:724-785)
        if ((ay[as1 + i] & (SEED_IGNORE | SEED_TANDEM)) && i != cnt1 - 1) {
            ++i;
            continue;
        }
        if (o.is_sr && !o.is_hpc) {
            re = lo32(ax[as1 + i]) + 1;
            qe = lo32(ay[as1 + i]) + 1;
        } else if (!o.is_hpc) {
            re = lo32(ax[as1 + i]) - (o.k >> 1);
            qe = lo32(ay[as1 + i]) - (o.k >> 1);
        } else {
            adjust_minier(o.is_hpc, o.k, seq_codes, offsets, fwd, rc,
                          ax[as1 + i], ay[as1 + i], re, qe);
        }
        re1 = re; qe1 = qe;
        if (i == cnt1 - 1 || (ay[as1 + i] & SEED_LONG_JOIN)
            || (qe - qs >= o.min_ksw_len && re - rs >= o.min_ksw_len)) {
            int64_t bw1 = o.bw_long;
            if (ay[as1 + i] & SEED_LONG_JOIN)
                bw1 = qe - qs > re - rs ? qe - qs : re - rs;
            const uint8_t *qsub = qstrand_qseq + qs;
            const uint8_t *tsub = tbase + rs;
            int64_t ql = qe - qs, tl = re - rs;
            if (o.is_sr) {  // ungapped (align.c:744-751)
                if (ql != tl) return -2;
                ez = EzC{};
                int64_t sc = 0;
                for (int64_t j = 0; j < ql; ++j) {
                    if (qsub[j] >= 4 || tsub[j] >= 4) sc += o.e2;
                    else if (qsub[j] == tsub[j]) sc += o.a;
                    else sc -= o.b;
                }
                ez.score = (int32_t)sc;
                ez.cig.assign(1, (uint32_t)(ql << 4) | OP_M);
            } else {
                align_pair_c(o, qsub, ql, tsub, tl, mat, bw1, -1, o.zdrop,
                             EZ_APPROX_MAX, ez);
            }
            // Collect mode (g_fill.mode == 1): the fill answer is a fake
            // giant-M cigar, on which mm_test_zdrop fires for every
            // divergent gap and the "lift approximate Z-drop" branch
            // below would re-run the FULL local kernel per gap — 5x the
            // whole collect pass, measured.  Skip the test: the zdrop
            // decision belongs to the REAL pass (real cigars); skipping
            // the early break only makes collect record the tail gaps
            // too, which the real pass's split regions need anyway, and
            // zcode re-fills run with flag 0 (non-APPROX_MAX) so they
            // never consult the table either way.
            int32_t zcode = g_fill.mode == 1 ? 0 : mmt_test_zdrop(
                qsub, tsub, ez.cig.data(), (int64_t)ez.cig.size(), mat,
                (int32_t)o.q, (int32_t)o.e, (int32_t)o.zdrop,
                (int32_t)o.zdrop_inv, (int32_t)o.max_gap,
                o.try_inv ? 1 : 0, (int32_t)(o.min_chain_score * o.a),
                (int32_t)o.min_dp_max);
            if (zcode != 0)  // lift approximate Z-drop (align.c:756-757)
                align_pair_c(o, qsub, ql, tsub, tl, mat, bw1, -1,
                             zcode == 2 ? o.zdrop_inv : o.zdrop, 0, ez);
            if (!ez.cig.empty()) {
                append_cigar(rcig, ez.cig);
                have_p = true;
            }
            if (ez.zdropped) {  // truncated by Z-drop (align.c:761-781)
                if (!have_p) {
                    if (!ez.cig.empty()) return -2;
                    have_p = true;
                }
                int64_t j = i - 1;
                while (j >= 0) {
                    if (lo32(ax[as1 + j]) <= rs + ez.max_t) break;
                    --j;
                }
                dropped = true;
                if (j < 0) j = 0;
                dp_score += ez.max;
                re1 = rs + ez.max_t + 1;
                qe1 = qs + ez.max_q + 1;
                if (cnt1 - (j + 1) >= o.min_cnt) {
                    split_n = as1 + j + 1 - as0;
                    split_code = zcode;
                }
                break;
            } else {
                // the oracle would AttributeError here if p were still
                // unset (no cigar ever appended); delegate to it so the
                // two paths behave identically
                if (!have_p) return -2;
                dp_score += ez.score;
            }
            rs = re; qs = qe;
        }
        ++i;
    }

    if (!dropped && qe < qe0 && re < re0) {  // right ext (align.c:787-803)
        align_pair_c(o, qstrand_qseq + qe, qe0 - qe, tbase + re, re0 - re,
                     mat, o.bw, o.end_bonus, o.zdrop, EZ_EXTZ_ONLY, ez);
        if (!ez.cig.empty()) {
            append_cigar(rcig, ez.cig);
            have_p = true;
            dp_score += ez.max;
        }
        re1 = re + (ez.reach_end ? ez.mqe_t + 1 : ez.max_t + 1);
        qe1 = qe + (ez.reach_end ? qe0 - qe : ez.max_q + 1);
    }
    if (qe1 > qlen) return -2;

    int64_t fin_rs = rs1, fin_re = re1, fin_qs, fin_qe;
    if (!rev) {
        fin_qs = qs1; fin_qe = qe1;
    } else {
        fin_qs = qlen - qe1; fin_qe = qlen - qs1;
    }

    int64_t blen = 0, mlen = 0, n_ambi = 0, dp_max = 0;
    if (have_p) {
        // mm_update_extra (align.c:240-289) on the oriented sequences
        const uint8_t *uq = (rev ? rc : fwd) + qs1;
        const uint8_t *ut = tbase + rs1;
        int64_t qshift, tshift;
        uint32_t lead_op;
        int64_t lead_len;
        if (!fix_cigar(rcig, uq, ut, fin_qe - fin_qs, fin_re - fin_rs,
                       qshift, tshift, lead_op, lead_len))
            return -2;
        if (lead_len > 0) {  // leading I/D trimmed: adjust coordinates
            if (lead_op == OP_I) {
                if (rev) fin_qe -= lead_len; else fin_qs += lead_len;
            } else {
                fin_rs += lead_len;
            }
        }
        uq += qshift;
        ut += tshift;
        int64_t toff = 0, qoff = 0;
        double s = 0.0, mx = 0.0;
        for (uint32_t c : rcig) {
            uint32_t op = c & 0xF;
            int64_t ln = c >> 4;
            if (op == OP_M) {
                int64_t na = 0, nd = 0;
                for (int64_t j = 0; j < ln; ++j) {
                    uint8_t cq = uq[qoff + j], ct = ut[toff + j];
                    bool ambi = ct > 3 || cq > 3;
                    if (ambi) ++na;
                    else if (ct != cq) ++nd;
                    s += (double)mat[ct * 5 + cq];
                    if (s < 0.0) s = 0.0;
                    else if (s > mx) mx = s;
                }
                blen += ln - na;
                mlen += ln - (na + nd);
                n_ambi += na;
                toff += ln; qoff += ln;
            } else if (op == OP_I) {
                int64_t na = 0;
                for (int64_t j = 0; j < ln; ++j)
                    if (uq[qoff + j] > 3) ++na;
                blen += ln - na;
                n_ambi += na;
                s -= (double)o.q
                     + (o.log_gap
                        ? (double)o.e * (double)mg_log2f(1.0 + (double)ln)
                        : (double)o.e);
                if (s < 0.0) s = 0.0;
                qoff += ln;
            } else if (op == OP_D) {
                int64_t na = 0;
                for (int64_t j = 0; j < ln; ++j)
                    if (ut[toff + j] > 3) ++na;
                blen += ln - na;
                n_ambi += na;
                s -= (double)o.q
                     + (o.log_gap
                        ? (double)o.e * (double)mg_log2f(1.0 + (double)ln)
                        : (double)o.e);
                if (s < 0.0) s = 0.0;
                toff += ln;
            } else if (op == OP_N) {
                toff += ln;
            }
        }
        dp_max = (int64_t)(mx + 0.499);
        if (qoff != fin_qe - fin_qs || toff != fin_re - fin_rs) return -2;
        if (o.is_eqx) update_cigar_eqx(rcig, uq, ut);
    }

    out[0] = have_p ? 1 : 0;
    out[1] = dp_score;
    out[2] = dp_max;
    out[3] = n_ambi;
    out[4] = blen;
    out[5] = mlen;
    out[6] = fin_rs; out[7] = fin_re; out[8] = fin_qs; out[9] = fin_qe;
    out[10] = split_n;
    out[11] = split_code;
    if ((int64_t)rcig.size() > cigar_cap) {
        out[0] = (int64_t)rcig.size();
        return -1;
    }
    std::memcpy(cigar_out, rcig.data(), rcig.size() * 4);
    return (int64_t)rcig.size();
}

// ---------------------------------------------------------------------
// fill-session C API (mm2_gb_tpu/utils/native.py bindings)

extern "C" void mmt_fill_mode(int32_t mode) {
    g_fill.mode = mode;
    if (mode == 1) {
        g_fill.meta.clear();
        g_fill.qblob.clear();
        g_fill.tblob.clear();
    }
    if (mode == 0) {
        g_fill.table.clear();
        g_fill.t_score.clear();
        g_fill.t_cig_blob.clear();
        g_fill.t_cig_off.clear();
    }
}

extern "C" void mmt_fill_counts(int64_t *n, int64_t *qbytes,
                                int64_t *tbytes) {
    *n = (int64_t)(g_fill.meta.size() / 4);
    *qbytes = (int64_t)g_fill.qblob.size();
    *tbytes = (int64_t)g_fill.tblob.size();
}

extern "C" void mmt_fill_fetch(int64_t *meta, uint8_t *qblob,
                               uint8_t *tblob) {
    std::memcpy(meta, g_fill.meta.data(), g_fill.meta.size() * 8);
    std::memcpy(qblob, g_fill.qblob.data(), g_fill.qblob.size());
    std::memcpy(tblob, g_fill.tblob.data(), g_fill.tblob.size());
}

// Bulk table load: n results with per-fill meta4 (ql, tl, w, zdrop),
// concatenated sequences (off arrays of n+1) and concatenated
// RLE cigars (uint32, off array of n+1).  Duplicate keys keep the
// first entry (all duplicates carry identical results).
extern "C" void mmt_fill_table_bulk(
    int64_t n, const int64_t *meta, const int64_t *qoff,
    const uint8_t *qblob, const int64_t *toff, const uint8_t *tblob,
    const int32_t *scores, const int64_t *cig_off,
    const uint32_t *cig_blob) {
    g_fill.table.reserve(g_fill.table.size() + (size_t)n * 2);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t ql = meta[i * 4], tl = meta[i * 4 + 1];
        std::string k = fill_key(qblob + qoff[i], ql, tblob + toff[i], tl,
                                 meta[i * 4 + 2], meta[i * 4 + 3]);
        auto ins = g_fill.table.emplace(std::move(k), g_fill.t_score.size());
        if (!ins.second) continue;
        g_fill.t_score.push_back(scores[i]);
        if (g_fill.t_cig_off.empty()) g_fill.t_cig_off.push_back(0);
        g_fill.t_cig_blob.insert(g_fill.t_cig_blob.end(),
                                 cig_blob + cig_off[i],
                                 cig_blob + cig_off[i + 1]);
        g_fill.t_cig_off.push_back((int64_t)g_fill.t_cig_blob.size());
    }
}
