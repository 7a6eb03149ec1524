// ksw2kit: native fast path for the ksw2-family extension DP.
//
// Same semantics as mm2_gb_tpu/ops/ksw2.py (the NumPy oracle), which is
// byte-exact with the reference's SSE4.1 kernels (ksw2_extz2_sse.c,
// ksw2_extd2_sse.c, ksw2_ll_sse.c): the anti-diagonal int8 difference
// recurrence including 16-lane band rounding, stale-lane persistence, the
// contiguous s/sf/qr memory plan, and the blocked row-argmax tie-breaking.
// Written as plain scalar int8 C++ (autovectorized); validated against the
// same golden cases as the oracle (tests/test_ksw2.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t KSW_NEG_INF = -0x40000000;

constexpr int32_t EZ_SCORE_ONLY = 0x01;
constexpr int32_t EZ_RIGHT = 0x02;
constexpr int32_t EZ_APPROX_MAX = 0x08;
constexpr int32_t EZ_APPROX_DROP = 0x10;
constexpr int32_t EZ_EXTZ_ONLY = 0x40;
constexpr int32_t EZ_REV_CIGAR = 0x80;

struct Ez {
    int32_t max = 0;
    int32_t zdropped = 0;
    int32_t max_q = -1, max_t = -1;
    int32_t mqe = KSW_NEG_INF, mqe_t = -1;
    int32_t mte = KSW_NEG_INF, mte_q = -1;
    int32_t score = KSW_NEG_INF;
    int32_t reach_end = 0;
};

inline bool apply_zdrop(Ez &ez, int32_t H, int r, int t, int zdrop, int e) {
    int q = r - t;
    if (H > ez.max) {
        ez.max = H; ez.max_t = t; ez.max_q = q;
    } else if (t >= ez.max_t && q >= ez.max_q) {
        int tl = t - ez.max_t, ql = q - ez.max_q;
        int l = tl > ql ? tl - ql : ql - tl;
        if (zdrop >= 0 && ez.max - H > zdrop + l * e) {
            ez.zdropped = 1;
            return true;
        }
    }
    return false;
}

inline bool row_window(int r, int qlen, int tlen, int w, int &st, int &en,
                       int &st0, int &en0) {
    st = 0; en = tlen - 1;
    if (st < r - qlen + 1) st = r - qlen + 1;
    if (en > r) en = r;
    if (st < (r - w + 1) >> 1) st = (r - w + 1) >> 1;
    if (en > (r + w) >> 1) en = (r + w) >> 1;
    if (st > en) return false;
    st0 = st; en0 = en;
    st = st / 16 * 16;
    en = (en + 16) / 16 * 16 - 1;
    return true;
}

// the reference kernels' [s][sf][qr] block: score stores at the tail of s
// spill into sf; query loads may dip below qr into sf
struct SMem {
    std::vector<int8_t> buf;
    int nbytes, qr_off;
    SMem(int tlen_, int qlen_) {
        nbytes = tlen_ * 16;
        qr_off = nbytes * 2;
        buf.assign((size_t)nbytes * 2 + qlen_ * 16 + 16, 0);
    }
    int8_t *s() { return buf.data(); }
    int8_t *sf() { return buf.data() + nbytes; }
    int8_t *qr() { return buf.data() + qr_off; }
    void fill_scores(int r, int qlen, int st0, int en0, int8_t mat0,
                     int8_t mat1, int8_t scN) {
        int n_stores = (en0 - st0) / 16 + 1;
        int lo = st0, hi = st0 + 16 * n_stores;
        const int8_t *sq = sf() + lo;
        const int8_t *qq = qr() + (qlen - 1 - r) + lo;
        int8_t *dst = s() + lo;
        for (int i = 0; i < hi - lo; ++i) {
            int8_t v = (sq[i] == qq[i]) ? mat0 : mat1;
            if (sq[i] == 4 || qq[i] == 4) v = scN;
            dst[i] = v;
        }
    }
};

// row max with the 4-lane blocked argmax tie-breaking (after H update)
inline void row_max(const int32_t *H, int st0, int en0, int32_t h_en0,
                    int32_t &max_H, int32_t &max_t) {
    max_H = h_en0; max_t = en0;
    int en1 = st0 + (en0 - st0) / 4 * 4;
    if (en1 > st0) {
        int32_t lmax[4]; int32_t larg[4];
        for (int i = 0; i < 4; ++i) { lmax[i] = h_en0; larg[i] = en0; }
        for (int t = st0; t < en1; t += 4)
            for (int i = 0; i < 4; ++i)
                if (H[t + i] > lmax[i]) { lmax[i] = H[t + i]; larg[i] = t + i; }
        for (int i = 0; i < 4; ++i)
            if (max_H < lmax[i]) { max_H = lmax[i]; max_t = larg[i]; }
    }
    for (int t = en1; t < en0; ++t)
        if (H[t] > max_H) { max_H = H[t]; max_t = t; }
}

inline void push_cigar(std::vector<uint32_t> &cig, uint32_t op, uint32_t len) {
    if (!cig.empty() && (cig.back() & 0xF) == op) cig.back() += len << 4;
    else cig.push_back(len << 4 | op);
}

void backtrack_core(const uint8_t *p, const int32_t *off,
                    const int32_t *off_end, int n_col, int i0, int j0,
                    bool rev_cigar, int min_intron_len,
                    std::vector<uint32_t> &cig) {
    int i = i0, j = j0, state = 0;
    while (i >= 0 && j >= 0) {
        int r = i + j, force_state = -1;
        if (i < off[r]) force_state = 2;
        if (i > off_end[r]) force_state = 1;
        uint32_t tmp = force_state < 0 ? p[(size_t)r * n_col + i - off[r]] : 0;
        if (state == 0) state = tmp & 7;
        else if (!(tmp >> (state + 2) & 1)) state = 0;
        if (state == 0) state = tmp & 7;
        if (force_state >= 0) state = force_state;
        if (state == 0) { push_cigar(cig, 0, 1); --i; --j; }
        else if (state == 1 || (state == 3 && min_intron_len <= 0)) {
            push_cigar(cig, 2, 1); --i;
        } else if (state == 3) { push_cigar(cig, 3, 1); --i; }
        else { push_cigar(cig, 1, 1); --j; }
    }
    if (i >= 0)
        push_cigar(cig, (min_intron_len > 0 && i >= min_intron_len) ? 3 : 2,
                   i + 1);
    if (j >= 0) push_cigar(cig, 1, j + 1);
    if (!rev_cigar) {
        for (size_t a = 0, b = cig.size(); a + 1 < b; ++a)
            std::swap(cig[a], cig[--b]);
    }
}

void backtrack(const uint8_t *p, const int32_t *off, const int32_t *off_end,
               int n_col, int i0, int j0, bool rev_cigar,
               std::vector<uint32_t> &cig) {
    backtrack_core(p, off, off_end, n_col, i0, j0, rev_cigar, 0, cig);
}

void backtrack_intron(const uint8_t *p, const int32_t *off,
                      const int32_t *off_end, int n_col, int i0, int j0,
                      bool rev_cigar, int min_intron_len,
                      std::vector<uint32_t> &cig) {
    backtrack_core(p, off, off_end, n_col, i0, j0, rev_cigar,
                   min_intron_len, cig);
}

int64_t finish(const Ez &ez, const std::vector<uint32_t> &cig,
               int32_t *ez_out, uint32_t *cigar_out, int64_t cigar_cap) {
    ez_out[0] = ez.score; ez_out[1] = ez.max; ez_out[2] = ez.max_q;
    ez_out[3] = ez.max_t; ez_out[4] = ez.mqe; ez_out[5] = ez.mqe_t;
    ez_out[6] = ez.mte; ez_out[7] = ez.mte_q; ez_out[8] = ez.zdropped;
    ez_out[9] = ez.reach_end;
    if ((int64_t)cig.size() > cigar_cap) return -1;
    std::memcpy(cigar_out, cig.data(), cig.size() * 4);
    return (int64_t)cig.size();
}



template <bool RIGHT, bool CIG>
static void extz2_row(int wdt, const int8_t *__restrict sr_,
                      const int8_t *__restrict xpr,
                      const int8_t *__restrict vpr,
                      int8_t *__restrict xr, int8_t *__restrict yr,
                      int8_t *__restrict ur, int8_t *__restrict vr,
                      uint8_t *__restrict pr, int8_t qe2_add, int8_t q,
                      uint8_t max_sc_clamp) {
    for (int k = 0; k < wdt; ++k) {
        int8_t xt1 = xpr[k], vt1 = vpr[k];
        int8_t z = (int8_t)(sr_[k] + qe2_add);
        int8_t a = (int8_t)(xt1 + vt1);
        int8_t ut = ur[k];
        int8_t b = (int8_t)(yr[k] + ut);
        uint8_t d;
        if (RIGHT) d = (z > a) ? 0 : 1;
        else d = (a > z) ? 1 : 0;
        z = z > a ? z : a;
        if (RIGHT) d = (z > b) ? d : 2;
        else d = (b > z) ? 2 : d;
        uint8_t zu = (uint8_t)z;
        uint8_t bu = (uint8_t)b;
        zu = zu > bu ? zu : bu;
        zu = zu < max_sc_clamp ? zu : max_sc_clamp;
        z = (int8_t)zu;
        ur[k] = (int8_t)(z - vt1);
        vr[k] = (int8_t)(z - ut);
        int8_t z2 = (int8_t)(z - q);
        a = (int8_t)(a - z2);
        b = (int8_t)(b - z2);
        bool ta = RIGHT ? (a >= 0) : (a > 0);
        bool tb = RIGHT ? (b >= 0) : (b > 0);
        xr[k] = ta ? a : 0;
        yr[k] = tb ? b : 0;
        if (CIG) {
            d |= ta ? 0x08 : 0;
            d |= tb ? 0x10 : 0;
            pr[k] = d;
        }
    }
}

template <bool RIGHT, bool CIG>
static void exts2_row(int wdt, const int8_t *__restrict sr_,
                      const int8_t *__restrict xpr,
                      const int8_t *__restrict vpr,
                      const int8_t *__restrict x2pr,
                      const int8_t *__restrict dnr,
                      const int8_t *__restrict acr,
                      int8_t *__restrict xr, int8_t *__restrict yr,
                      int8_t *__restrict x2r, int8_t *__restrict ur,
                      int8_t *__restrict vr, uint8_t *__restrict pr,
                      int8_t q, int8_t q2, int8_t qe) {
    for (int k = 0; k < wdt; ++k) {
        int8_t xt1 = xpr[k], x2t1 = x2pr[k], vt1 = vpr[k];
        int8_t z = sr_[k];
        int8_t a = (int8_t)(xt1 + vt1);
        int8_t ut = ur[k];
        int8_t b = (int8_t)(yr[k] + ut);
        int8_t a2 = (int8_t)(x2t1 + vt1);
        int8_t a2a = (int8_t)(a2 + acr[k]);
        uint8_t d;
        if (RIGHT) {
            d = (z > a) ? 0 : 1; z = z > a ? z : a;
            d = (z > b) ? d : 2; z = z > b ? z : b;
            d = (z > a2a) ? d : 3; z = z > a2a ? z : a2a;
        } else {
            d = (a > z) ? 1 : 0; z = z > a ? z : a;
            d = (b > z) ? 2 : d; z = z > b ? z : b;
            d = (a2a > z) ? 3 : d; z = z > a2a ? z : a2a;
        }
        ur[k] = (int8_t)(z - vt1);
        vr[k] = (int8_t)(z - ut);
        int8_t tq = (int8_t)(z - q);
        a = (int8_t)(a - tq);
        b = (int8_t)(b - tq);
        a2 = (int8_t)(a2 - (int8_t)(z - q2));
        bool ta = RIGHT ? (a >= 0) : (a > 0);
        bool tb = RIGHT ? (b >= 0) : (b > 0);
        bool ta2 = RIGHT ? (a2 >= dnr[k]) : (a2 > dnr[k]);
        xr[k] = (int8_t)((ta ? a : 0) - qe);
        yr[k] = (int8_t)((tb ? b : 0) - qe);
        x2r[k] = (int8_t)((ta2 ? a2 : dnr[k]) - q2);
        if (CIG) {
            d |= ta ? 0x08 : 0;
            d |= tb ? 0x10 : 0;
            d |= ta2 ? 0x20 : 0;
            pr[k] = d;
        }
    }
}

template <bool RIGHT, bool CIG>
static void extd2_row(int wdt, const int8_t *__restrict sr_,
                      const int8_t *__restrict xpr,
                      const int8_t *__restrict vpr,
                      const int8_t *__restrict x2pr,
                      int8_t *__restrict xr, int8_t *__restrict yr,
                      int8_t *__restrict x2r, int8_t *__restrict y2r,
                      int8_t *__restrict ur, int8_t *__restrict vr,
                      uint8_t *__restrict pr, int8_t mat0, int8_t q,
                      int8_t q2, int8_t qe, int8_t qe2) {
    for (int k = 0; k < wdt; ++k) {
        int8_t xt1 = xpr[k], x2t1 = x2pr[k], vt1 = vpr[k];
        int8_t z = sr_[k];
        int8_t a = (int8_t)(xt1 + vt1);
        int8_t ut = ur[k];
        int8_t b = (int8_t)(yr[k] + ut);
        int8_t a2 = (int8_t)(x2t1 + vt1);
        int8_t b2 = (int8_t)(y2r[k] + ut);
        uint8_t d;
        if (RIGHT) {
            d = (z > a) ? 0 : 1; z = z > a ? z : a;
            d = (z > b) ? d : 2; z = z > b ? z : b;
            d = (z > a2) ? d : 3; z = z > a2 ? z : a2;
            d = (z > b2) ? d : 4; z = z > b2 ? z : b2;
        } else {
            d = (a > z) ? 1 : 0; z = z > a ? z : a;
            d = (b > z) ? 2 : d; z = z > b ? z : b;
            d = (a2 > z) ? 3 : d; z = z > a2 ? z : a2;
            d = (b2 > z) ? 4 : d; z = z > b2 ? z : b2;
        }
        z = z < mat0 ? z : mat0;
        ur[k] = (int8_t)(z - vt1);
        vr[k] = (int8_t)(z - ut);
        int8_t tq = (int8_t)(z - q);
        a = (int8_t)(a - tq);
        b = (int8_t)(b - tq);
        int8_t tq2 = (int8_t)(z - q2);
        a2 = (int8_t)(a2 - tq2);
        b2 = (int8_t)(b2 - tq2);
        bool ta = RIGHT ? (a >= 0) : (a > 0);
        bool tb = RIGHT ? (b >= 0) : (b > 0);
        bool ta2 = RIGHT ? (a2 >= 0) : (a2 > 0);
        bool tb2 = RIGHT ? (b2 >= 0) : (b2 > 0);
        xr[k] = (int8_t)((ta ? a : 0) - qe);
        yr[k] = (int8_t)((tb ? b : 0) - qe);
        x2r[k] = (int8_t)((ta2 ? a2 : 0) - qe2);
        y2r[k] = (int8_t)((tb2 ? b2 : 0) - qe2);
        if (CIG) {
            d |= ta ? 0x08 : 0;
            d |= tb ? 0x10 : 0;
            d |= ta2 ? 0x20 : 0;
            d |= tb2 ? 0x40 : 0;
            pr[k] = d;
        }
    }
}

}  // namespace

extern "C" {

int64_t mmt_ksw_extz2(const uint8_t *qseq, int32_t qlen, const uint8_t *tseq,
                      int32_t tlen, const int8_t *mat, int32_t m, int32_t q,
                      int32_t e, int32_t w, int32_t zdrop, int32_t end_bonus,
                      int32_t flag, int32_t *ez_out, uint32_t *cigar_out,
                      int64_t cigar_cap) {
    Ez ez;
    std::vector<uint32_t> cig;
    if (m <= 0 || qlen <= 0 || tlen <= 0)
        return finish(ez, cig, ez_out, cigar_out, cigar_cap);
    const bool with_cigar = !(flag & EZ_SCORE_ONLY);
    const bool approx_max = flag & EZ_APPROX_MAX;
    const bool right = flag & EZ_RIGHT;
    const int8_t mat0 = mat[0], mat1 = mat[1];
    const int8_t scN = mat[m * m - 1] == 0 ? (int8_t)-e : mat[m * m - 1];
    const uint8_t max_sc_clamp = (uint8_t)(mat0 + (q + e) * 2);
    int8_t min_sc = mat[0];
    for (int t = 1; t < m * m; ++t) if (mat[t] < min_sc) min_sc = mat[t];
    if (-min_sc > 2 * (q + e))
        return finish(ez, cig, ez_out, cigar_out, cigar_cap);
    if (w < 0) w = tlen > qlen ? tlen : qlen;
    const int tlen_ = (tlen + 15) / 16, qlen_ = (qlen + 15) / 16;
    int n_col = qlen < tlen ? qlen : tlen;
    n_col = ((n_col < w + 1 ? n_col : w + 1) + 15) / 16 * 16 + 16;
    const int nbytes = tlen_ * 16, n_rows = qlen + tlen - 1;

    std::vector<int8_t> u(nbytes, 0), v(nbytes, 0), x(nbytes, 0), y(nbytes, 0);
    std::vector<int8_t> xp(n_col + 1), vp(n_col + 1);
    SMem sm(tlen_, qlen_);
    std::memcpy(sm.sf(), tseq, tlen);
    for (int t = 0; t < qlen; ++t) sm.qr()[t] = (int8_t)qseq[qlen - 1 - t];
    std::vector<int32_t> H;
    if (!approx_max) H.assign(nbytes, KSW_NEG_INF);
    std::vector<uint8_t> P;
    std::vector<int32_t> off(n_rows, 0), off_end(n_rows, 0);
    if (with_cigar) P.assign((size_t)n_rows * n_col, 0);

    const int qe = q + e;
    int32_t H0 = 0; int last_H0_t = 0;
    int last_st = -1, last_en = -1;
    const uint8_t *u8 = (const uint8_t *)u.data();
    const uint8_t *v8 = (const uint8_t *)v.data();

    for (int r = 0; r < n_rows; ++r) {
        int st, en, st0, en0;
        if (!row_window(r, qlen, tlen, w, st, en, st0, en0)) {
            ez.zdropped = 1;
            break;
        }
        int8_t x1, v1;
        if (st > 0) {
            if (st - 1 >= last_st && st - 1 <= last_en) { x1 = x[st - 1]; v1 = v[st - 1]; }
            else { x1 = 0; v1 = 0; }
        } else { x1 = 0; v1 = r ? (int8_t)q : 0; }
        if (en >= r) { y[r] = 0; u[r] = r ? (int8_t)q : 0; }
        sm.fill_scores(r, qlen, st0, en0, mat0, mat1, scN);

        uint8_t *pr = with_cigar ? P.data() + (size_t)r * n_col : nullptr;
        if (with_cigar) { off[r] = st; off_end[r] = en; }
        // stage the previous row's shifted x/v so the loop has no carried
        // dependence and autovectorizes (the SSE kernels' register shift)
        const int wdt = en - st + 1;
        xp[0] = x1; vp[0] = v1;
        std::memcpy(&xp[1], &x[st], wdt - 1);
        std::memcpy(&vp[1], &v[st], wdt - 1);
        int8_t *__restrict xr = x.data() + st;
        int8_t *__restrict yr = y.data() + st;
        int8_t *__restrict ur = u.data() + st;
        int8_t *__restrict vr = v.data() + st;
        const int8_t *__restrict sr_ = sm.s() + st;
        const int8_t *__restrict xpr = xp.data();
        const int8_t *__restrict vpr = vp.data();
        {
            auto row = with_cigar
                ? (right ? extz2_row<true, true> : extz2_row<false, true>)
                : (right ? extz2_row<true, false> : extz2_row<false, false>);
            row(wdt, sr_, xpr, vpr, xr, yr, ur, vr, pr,
                (int8_t)((q + e) * 2), (int8_t)q, max_sc_clamp);
        }

        if (!approx_max) {
            int32_t max_H, max_t, h_en0;
            if (r > 0) {
                h_en0 = en0 > 0 ? H[en0 - 1] + u8[en0] - qe : H[en0] + v8[en0] - qe;
                H[en0] = h_en0;
                for (int t = st0; t < en0; ++t) H[t] += (int32_t)v8[t] - qe;
                row_max(H.data(), st0, en0, h_en0, max_H, max_t);
            } else {
                H[0] = (int32_t)v8[0] - qe - qe;
                max_H = H[0]; max_t = 0;
            }
            if (en0 == tlen - 1 && H[en0] > ez.mte) { ez.mte = H[en0]; ez.mte_q = r - en; }
            if (r - st0 == qlen - 1 && H[st0] > ez.mqe) { ez.mqe = H[st0]; ez.mqe_t = st0; }
            if (apply_zdrop(ez, max_H, r, max_t, zdrop, e)) break;
            if (r == n_rows - 1 && en0 == tlen - 1) ez.score = H[tlen - 1];
        } else {
            if (r > 0) {
                if (last_H0_t >= st0 && last_H0_t <= en0 &&
                    last_H0_t + 1 >= st0 && last_H0_t + 1 <= en0) {
                    int32_t d0 = (int32_t)v8[last_H0_t] - qe;
                    int32_t d1 = (int32_t)u8[last_H0_t + 1] - qe;
                    if (d0 > d1) H0 += d0;
                    else { H0 += d1; ++last_H0_t; }
                } else if (last_H0_t >= st0 && last_H0_t <= en0) {
                    H0 += (int32_t)v8[last_H0_t] - qe;
                } else {
                    ++last_H0_t;
                    H0 += (int32_t)u8[last_H0_t] - qe;
                }
                if ((flag & EZ_APPROX_DROP) &&
                    apply_zdrop(ez, H0, r, last_H0_t, zdrop, e)) break;
            } else { H0 = (int32_t)v8[0] - qe - qe; last_H0_t = 0; }
            if (r == n_rows - 1 && en0 == tlen - 1) ez.score = H0;
        }
        last_st = st; last_en = en;
    }

    if (with_cigar) {
        bool rev = flag & EZ_REV_CIGAR;
        if (!ez.zdropped && !(flag & EZ_EXTZ_ONLY))
            backtrack(P.data(), off.data(), off_end.data(), n_col, tlen - 1,
                      qlen - 1, rev, cig);
        else if (!ez.zdropped && (flag & EZ_EXTZ_ONLY) &&
                 ez.mqe + end_bonus > ez.max) {
            ez.reach_end = 1;
            backtrack(P.data(), off.data(), off_end.data(), n_col, ez.mqe_t,
                      qlen - 1, rev, cig);
        } else if (ez.max_t >= 0 && ez.max_q >= 0)
            backtrack(P.data(), off.data(), off_end.data(), n_col, ez.max_t,
                      ez.max_q, rev, cig);
    }
    return finish(ez, cig, ez_out, cigar_out, cigar_cap);
}

int64_t mmt_ksw_extd2(const uint8_t *qseq, int32_t qlen, const uint8_t *tseq,
                      int32_t tlen, const int8_t *mat, int32_t m, int32_t q,
                      int32_t e, int32_t q2, int32_t e2, int32_t w,
                      int32_t zdrop, int32_t end_bonus, int32_t flag,
                      int32_t *ez_out, uint32_t *cigar_out,
                      int64_t cigar_cap) {
    Ez ez;
    std::vector<uint32_t> cig;
    if (m <= 1 || qlen <= 0 || tlen <= 0)
        return finish(ez, cig, ez_out, cigar_out, cigar_cap);
    if (q2 + e2 < q + e) { int t = q; q = q2; q2 = t; t = e; e = e2; e2 = t; }
    const bool with_cigar = !(flag & EZ_SCORE_ONLY);
    const bool approx_max = flag & EZ_APPROX_MAX;
    const bool right = flag & EZ_RIGHT;
    const int8_t mat0 = mat[0], mat1 = mat[1];
    const int8_t scN = mat[m * m - 1] == 0 ? (int8_t)-e2 : mat[m * m - 1];
    int8_t min_sc = mat[0];
    for (int t = 1; t < m * m; ++t) if (mat[t] < min_sc) min_sc = mat[t];
    if (-min_sc > 2 * (q + e))
        return finish(ez, cig, ez_out, cigar_out, cigar_cap);
    if (w < 0) w = tlen > qlen ? tlen : qlen;
    const int tlen_ = (tlen + 15) / 16, qlen_ = (qlen + 15) / 16;
    int n_col = qlen < tlen ? qlen : tlen;
    n_col = ((n_col < w + 1 ? n_col : w + 1) + 15) / 16 * 16 + 16;
    const int nbytes = tlen_ * 16, n_rows = qlen + tlen - 1;

    int long_thres = e != e2 ? (q2 - q) / (e - e2) - 1 : 0;
    if (q2 + e2 + long_thres * e2 > q + e + long_thres * e) ++long_thres;
    const int long_diff = long_thres * (e - e2) - (q2 - q) - e2;
    const int8_t nqe = (int8_t)(-q - e), nqe2 = (int8_t)(-q2 - e2);

    std::vector<int8_t> u(nbytes, nqe), v(nbytes, nqe), x(nbytes, nqe),
        y(nbytes, nqe), x2(nbytes, nqe2), y2(nbytes, nqe2);
    std::vector<int8_t> xp(n_col + 1), vp(n_col + 1), x2p(n_col + 1);
    SMem sm(tlen_, qlen_);
    std::memcpy(sm.sf(), tseq, tlen);
    for (int t = 0; t < qlen; ++t) sm.qr()[t] = (int8_t)qseq[qlen - 1 - t];
    std::vector<int32_t> H;
    if (!approx_max) H.assign(nbytes, KSW_NEG_INF);
    std::vector<uint8_t> P;
    std::vector<int32_t> off(n_rows, 0), off_end(n_rows, 0);
    if (with_cigar) P.assign((size_t)n_rows * n_col, 0);

    const int qe = q + e;
    int32_t H0 = 0; int last_H0_t = 0;
    int last_st = -1, last_en = -1;

    auto bound_v = [&](int r) -> int8_t {
        if (r == 0) return nqe;
        if (r < long_thres) return (int8_t)-e;
        if (r == long_thres) return (int8_t)long_diff;
        return (int8_t)-e2;
    };

    for (int r = 0; r < n_rows; ++r) {
        int st, en, st0, en0;
        if (!row_window(r, qlen, tlen, w, st, en, st0, en0)) {
            ez.zdropped = 1;
            break;
        }
        int8_t x1, x21, v1;
        if (st > 0) {
            if (st - 1 >= last_st && st - 1 <= last_en) {
                x1 = x[st - 1]; x21 = x2[st - 1]; v1 = v[st - 1];
            } else { x1 = nqe; x21 = nqe2; v1 = nqe; }
        } else { x1 = nqe; x21 = nqe2; v1 = bound_v(r); }
        if (en >= r) { y[r] = nqe; y2[r] = nqe2; u[r] = bound_v(r); }
        sm.fill_scores(r, qlen, st0, en0, mat0, mat1, scN);

        uint8_t *pr = with_cigar ? P.data() + (size_t)r * n_col : nullptr;
        if (with_cigar) { off[r] = st; off_end[r] = en; }
        const int wdt = en - st + 1;
        xp[0] = x1; vp[0] = v1; x2p[0] = x21;
        std::memcpy(&xp[1], &x[st], wdt - 1);
        std::memcpy(&vp[1], &v[st], wdt - 1);
        std::memcpy(&x2p[1], &x2[st], wdt - 1);
        int8_t *__restrict xr = x.data() + st;
        int8_t *__restrict yr = y.data() + st;
        int8_t *__restrict x2r = x2.data() + st;
        int8_t *__restrict y2r = y2.data() + st;
        int8_t *__restrict ur = u.data() + st;
        int8_t *__restrict vr = v.data() + st;
        const int8_t *__restrict sr_ = sm.s() + st;
        const int8_t *__restrict xpr = xp.data();
        const int8_t *__restrict vpr = vp.data();
        const int8_t *__restrict x2pr = x2p.data();
        {
            auto row = with_cigar
                ? (right ? extd2_row<true, true> : extd2_row<false, true>)
                : (right ? extd2_row<true, false> : extd2_row<false, false>);
            row(wdt, sr_, xpr, vpr, x2pr, xr, yr, x2r, y2r, ur, vr, pr,
                mat0, (int8_t)q, (int8_t)q2, (int8_t)qe, (int8_t)(q2 + e2));
        }

        if (!approx_max) {
            int32_t max_H, max_t, h_en0;
            if (r > 0) {
                h_en0 = en0 > 0 ? H[en0 - 1] + u[en0] : H[en0] + v[en0];
                H[en0] = h_en0;
                for (int t = st0; t < en0; ++t) H[t] += (int32_t)v[t];
                row_max(H.data(), st0, en0, h_en0, max_H, max_t);
            } else {
                H[0] = (int32_t)v[0] - qe;
                max_H = H[0]; max_t = 0;
            }
            if (en0 == tlen - 1 && H[en0] > ez.mte) { ez.mte = H[en0]; ez.mte_q = r - en; }
            if (r - st0 == qlen - 1 && H[st0] > ez.mqe) { ez.mqe = H[st0]; ez.mqe_t = st0; }
            if (apply_zdrop(ez, max_H, r, max_t, zdrop, e2)) break;
            if (r == n_rows - 1 && en0 == tlen - 1) ez.score = H[tlen - 1];
        } else {
            if (r > 0) {
                if (last_H0_t >= st0 && last_H0_t <= en0 &&
                    last_H0_t + 1 >= st0 && last_H0_t + 1 <= en0) {
                    int32_t d0 = v[last_H0_t];
                    int32_t d1 = u[last_H0_t + 1];
                    if (d0 > d1) H0 += d0;
                    else { H0 += d1; ++last_H0_t; }
                } else if (last_H0_t >= st0 && last_H0_t <= en0) {
                    H0 += v[last_H0_t];
                } else {
                    ++last_H0_t;
                    H0 += u[last_H0_t];
                }
                if ((flag & EZ_APPROX_DROP) &&
                    apply_zdrop(ez, H0, r, last_H0_t, zdrop, e2)) break;
            } else { H0 = (int32_t)v[0] - qe; last_H0_t = 0; }
            if (r == n_rows - 1 && en0 == tlen - 1) ez.score = H0;
        }
        last_st = st; last_en = en;
    }

    if (with_cigar) {
        bool rev = flag & EZ_REV_CIGAR;
        if (!ez.zdropped && !(flag & EZ_EXTZ_ONLY))
            backtrack(P.data(), off.data(), off_end.data(), n_col, tlen - 1,
                      qlen - 1, rev, cig);
        else if (!ez.zdropped && (flag & EZ_EXTZ_ONLY) &&
                 ez.mqe + end_bonus > ez.max) {
            ez.reach_end = 1;
            backtrack(P.data(), off.data(), off_end.data(), n_col, ez.mqe_t,
                      qlen - 1, rev, cig);
        } else if (ez.max_t >= 0 && ez.max_q >= 0)
            backtrack(P.data(), off.data(), off_end.data(), n_col, ez.max_t,
                      ez.max_q, rev, cig);
    }
    return finish(ez, cig, ez_out, cigar_out, cigar_cap);
}

// plain SW over the striped-padded query (ksw_ll_i16 semantics); returns
// score, and writes qe/te with the striped-order tie-breaking
int32_t mmt_sw_ll(const uint8_t *qseq, int32_t qlen, const uint8_t *tseq,
                  int32_t tlen, const int8_t *mat, int32_t m, int32_t gapo,
                  int32_t gape, int32_t *qe_out, int32_t *te_out) {
    const int slen = (qlen + 7) / 8, qlen8 = slen * 8;
    const int gapoe = gapo + gape;
    std::vector<int32_t> prof((size_t)m * qlen8, 0);
    for (int a = 0; a < m; ++a)
        for (int k = 0; k < qlen; ++k)
            prof[(size_t)a * qlen8 + k] = mat[a * m + qseq[k]];
    std::vector<int32_t> Hp(qlen8, 0), Hc(qlen8, 0), E(qlen8, 0),
        Hmax(qlen8, 0);
    int32_t gmax = 0, te = -1;
    for (int i = 0; i < tlen; ++i) {
        const int32_t *S = prof.data() + (size_t)tseq[i] * qlen8;
        int32_t f = 0, imax = 0;
        for (int j = 0; j < qlen8; ++j) {
            int32_t e_ = E[j] - gape, h_ = Hp[j] - gapoe;
            int32_t ee = e_ > h_ ? e_ : h_;
            if (ee < 0) ee = 0;
            E[j] = ee;
            int32_t diag = j ? Hp[j - 1] : 0;
            int32_t h0 = diag + S[j];
            if (ee > h0) h0 = ee;
            if (f > h0) h0 = f;
            if (h0 < 0) h0 = 0;
            Hc[j] = h0;
            if (h0 > imax) imax = h0;
            int32_t f1 = f - gape, f2 = h0 - gapoe;
            f = f1 > f2 ? f1 : f2;
            if (f < 0) f = 0;
        }
        if (imax >= gmax) {
            gmax = imax; te = i;
            Hmax = Hc;
        }
        std::swap(Hp, Hc);
    }
    int32_t qe = -1;
    for (int mem_i = 0; mem_i < qlen8; ++mem_i) {
        int qpos = mem_i / 8 + (mem_i % 8) * slen;
        if (Hmax[qpos] == gmax) qe = qpos;
    }
    *qe_out = qe;
    *te_out = te;
    return gmax;
}

}  // extern "C"

// splice-aware extension (ksw_exts2_sse semantics; see ops/ksw2_splice.py)
extern "C" int64_t mmt_ksw_exts2(const uint8_t *qseq, int32_t qlen,
                                 const uint8_t *tseq, int32_t tlen,
                                 const int8_t *mat, int32_t m, int32_t q,
                                 int32_t e, int32_t q2, int32_t noncan,
                                 int32_t zdrop, int32_t junc_bonus,
                                 int32_t flag, const uint8_t *junc,
                                 int32_t *ez_out, uint32_t *cigar_out,
                                 int64_t cigar_cap) {
    constexpr int32_t EZ_SPLICE_FOR = 0x100, EZ_SPLICE_REV = 0x200,
        EZ_SPLICE_FLANK = 0x400;
    Ez ez;
    std::vector<uint32_t> cig;
    if (m <= 1 || qlen <= 0 || tlen <= 0 || q2 <= q + e)
        return finish(ez, cig, ez_out, cigar_out, cigar_cap);
    const bool with_cigar = !(flag & EZ_SCORE_ONLY);
    const bool approx_max = flag & EZ_APPROX_MAX;
    const bool right = flag & EZ_RIGHT;
    const int8_t mat0 = mat[0], mat1 = mat[1];
    const int8_t scN = mat[m * m - 1] == 0 ? (int8_t)-e : mat[m * m - 1];
    int8_t min_sc = mat[0];
    for (int t = 1; t < m * m; ++t) if (mat[t] < min_sc) min_sc = mat[t];
    if (-min_sc > 2 * (q + e))
        return finish(ez, cig, ez_out, cigar_out, cigar_cap);
    const int tlen_ = (tlen + 15) / 16, qlen_ = (qlen + 15) / 16;
    const int n_col = ((qlen < tlen ? qlen : tlen) + 15) / 16 * 16 + 16;
    const int nbytes = tlen_ * 16, n_rows = qlen + tlen - 1;

    int long_thres = (q2 - q) / e - 1;
    if (q2 > q + e + long_thres * e) ++long_thres;
    const int long_diff = long_thres * e - (q2 - q);
    const int8_t nqe = (int8_t)(-q - e);

    std::vector<int8_t> u(nbytes, nqe), v(nbytes, nqe), x(nbytes, nqe),
        y(nbytes, nqe), x2(nbytes, (int8_t)-q2);
    std::vector<int8_t> xp(n_col + 1), vp(n_col + 1), x2p(n_col + 1);
    std::vector<int8_t> donor(nbytes, (int8_t)-noncan),
        acceptor(nbytes, (int8_t)-noncan);
    SMem sm(tlen_, qlen_);
    std::memcpy(sm.sf(), tseq, tlen);
    for (int t = 0; t < qlen; ++t) sm.qr()[t] = (int8_t)qseq[qlen - 1 - t];

    if (flag & (EZ_SPLICE_FOR | EZ_SPLICE_REV)) {
        // C truncation: -noncan/2 (GTr/yAG worth 0.5 bit, PMID:18688272)
        const int semi = (flag & EZ_SPLICE_FLANK) ? -(noncan / 2) : 0;
        const bool sfor = flag & EZ_SPLICE_FOR, srev = flag & EZ_SPLICE_REV;
        const uint8_t *t_ = tseq;
        if (!(flag & EZ_REV_CIGAR)) {
            for (int i = 0; i < tlen - 4; ++i) {
                int can = 0;
                if (sfor && t_[i+1] == 2 && t_[i+2] == 3) can = 1;
                if (srev && t_[i+1] == 1 && t_[i+2] == 3) can = 1;
                if (can && (t_[i+3] == 0 || t_[i+3] == 2)) can = 2;
                if (can) donor[i] = can == 2 ? 0 : (int8_t)semi;
            }
            if (junc)
                for (int i = 0; i < tlen - 1; ++i)
                    if ((sfor && (junc[i+1] & 1)) || (srev && (junc[i+1] & 8)))
                        donor[i] = (int8_t)(donor[i] + junc_bonus);
            for (int i = 2; i < tlen; ++i) {
                int can = 0;
                if (sfor && t_[i-1] == 0 && t_[i] == 2) can = 1;
                if (srev && t_[i-1] == 0 && t_[i] == 1) can = 1;
                if (can && (t_[i-2] == 1 || t_[i-2] == 3)) can = 2;
                if (can) acceptor[i] = can == 2 ? 0 : (int8_t)semi;
            }
            if (junc)
                for (int i = 0; i < tlen; ++i)
                    if ((sfor && (junc[i] & 2)) || (srev && (junc[i] & 4)))
                        acceptor[i] = (int8_t)(acceptor[i] + junc_bonus);
        } else {
            for (int i = 0; i < tlen - 4; ++i) {
                int can = 0;
                if (sfor && t_[i+1] == 2 && t_[i+2] == 0) can = 1;
                if (srev && t_[i+1] == 1 && t_[i+2] == 0) can = 1;
                if (can && (t_[i+3] == 1 || t_[i+3] == 3)) can = 2;
                if (can) donor[i] = can == 2 ? 0 : (int8_t)semi;
            }
            if (junc)
                for (int i = 0; i < tlen - 1; ++i)
                    if ((sfor && (junc[i+1] & 2)) || (srev && (junc[i+1] & 4)))
                        donor[i] = (int8_t)(donor[i] + junc_bonus);
            for (int i = 2; i < tlen; ++i) {
                int can = 0;
                if (sfor && t_[i-1] == 3 && t_[i] == 2) can = 1;
                if (srev && t_[i-1] == 3 && t_[i] == 1) can = 1;
                if (can && (t_[i-2] == 0 || t_[i-2] == 2)) can = 2;
                if (can) acceptor[i] = can == 2 ? 0 : (int8_t)semi;
            }
            if (junc)
                for (int i = 0; i < tlen; ++i)
                    if ((sfor && (junc[i] & 1)) || (srev && (junc[i] & 8)))
                        acceptor[i] = (int8_t)(acceptor[i] + junc_bonus);
        }
    }

    std::vector<int32_t> H;
    if (!approx_max) H.assign(nbytes, KSW_NEG_INF);
    std::vector<uint8_t> P;
    std::vector<int32_t> off(n_rows, 0), off_end(n_rows, 0);
    if (with_cigar) P.assign((size_t)n_rows * n_col, 0);

    const int qe = q + e;
    int32_t H0 = 0; int last_H0_t = 0;
    int last_st = -1, last_en = -1;
    auto bound_v = [&](int r) -> int8_t {
        if (r == 0) return nqe;
        if (r < long_thres) return (int8_t)-e;
        if (r == long_thres) return (int8_t)long_diff;
        return 0;
    };

    for (int r = 0; r < n_rows; ++r) {
        int st = r - qlen + 1 > 0 ? r - qlen + 1 : 0;
        int en = r < tlen - 1 ? r : tlen - 1;
        int st0 = st, en0 = en;
        st = st / 16 * 16;
        en = (en + 16) / 16 * 16 - 1;
        int8_t x1, x21, v1;
        if (st > 0) {
            if (st - 1 >= last_st && st - 1 <= last_en) {
                x1 = x[st - 1]; x21 = x2[st - 1]; v1 = v[st - 1];
            } else { x1 = nqe; x21 = (int8_t)-q2; v1 = nqe; }
        } else { x1 = nqe; x21 = (int8_t)-q2; v1 = bound_v(r); }
        if (en >= r) { y[r] = nqe; u[r] = bound_v(r); }
        sm.fill_scores(r, qlen, st0, en0, mat0, mat1, scN);

        uint8_t *pr = with_cigar ? P.data() + (size_t)r * n_col : nullptr;
        if (with_cigar) { off[r] = st; off_end[r] = en; }
        const int wdt = en - st + 1;
        xp[0] = x1; vp[0] = v1; x2p[0] = x21;
        std::memcpy(&xp[1], &x[st], wdt - 1);
        std::memcpy(&vp[1], &v[st], wdt - 1);
        std::memcpy(&x2p[1], &x2[st], wdt - 1);
        int8_t *__restrict xr = x.data() + st;
        int8_t *__restrict yr = y.data() + st;
        int8_t *__restrict x2r = x2.data() + st;
        int8_t *__restrict ur = u.data() + st;
        int8_t *__restrict vr = v.data() + st;
        const int8_t *__restrict sr_ = sm.s() + st;
        const int8_t *__restrict dnr = donor.data() + st;
        const int8_t *__restrict acr = acceptor.data() + st;
        const int8_t *__restrict xpr = xp.data();
        const int8_t *__restrict vpr = vp.data();
        const int8_t *__restrict x2pr = x2p.data();
        {
            auto row = with_cigar
                ? (right ? exts2_row<true, true> : exts2_row<false, true>)
                : (right ? exts2_row<true, false> : exts2_row<false, false>);
            row(wdt, sr_, xpr, vpr, x2pr, dnr, acr, xr, yr, x2r, ur, vr, pr,
                (int8_t)q, (int8_t)q2, (int8_t)qe);
        }

        if (!approx_max) {
            int32_t max_H, max_t, h_en0;
            if (r > 0) {
                h_en0 = en0 > 0 ? H[en0 - 1] + u[en0] : H[en0] + v[en0];
                H[en0] = h_en0;
                for (int t = st0; t < en0; ++t) H[t] += (int32_t)v[t];
                row_max(H.data(), st0, en0, h_en0, max_H, max_t);
            } else {
                H[0] = (int32_t)v[0] - qe;
                max_H = H[0]; max_t = 0;
            }
            if (en0 == tlen - 1 && H[en0] > ez.mte) { ez.mte = H[en0]; ez.mte_q = r - en; }
            if (r - st0 == qlen - 1 && H[st0] > ez.mqe) { ez.mqe = H[st0]; ez.mqe_t = st0; }
            if (apply_zdrop(ez, max_H, r, max_t, zdrop, 0)) break;
            if (r == n_rows - 1 && en0 == tlen - 1) ez.score = H[tlen - 1];
        } else {
            if (r > 0) {
                if (last_H0_t >= st0 && last_H0_t <= en0 &&
                    last_H0_t + 1 >= st0 && last_H0_t + 1 <= en0) {
                    int32_t d0 = v[last_H0_t], d1 = u[last_H0_t + 1];
                    if (d0 > d1) H0 += d0;
                    else { H0 += d1; ++last_H0_t; }
                } else if (last_H0_t >= st0 && last_H0_t <= en0) {
                    H0 += v[last_H0_t];
                } else { ++last_H0_t; H0 += u[last_H0_t]; }
                if ((flag & EZ_APPROX_DROP) &&
                    apply_zdrop(ez, H0, r, last_H0_t, zdrop, 0)) break;
            } else { H0 = (int32_t)v[0] - qe; last_H0_t = 0; }
            if (r == n_rows - 1 && en0 == tlen - 1) ez.score = H0;
        }
        last_st = st; last_en = en;
    }

    if (with_cigar) {
        bool rev = flag & EZ_REV_CIGAR;
        if (!ez.zdropped && !(flag & EZ_EXTZ_ONLY))
            backtrack_intron(P.data(), off.data(), off_end.data(), n_col,
                             tlen - 1, qlen - 1, rev, long_thres, cig);
        else if (ez.max_t >= 0 && ez.max_q >= 0)
            backtrack_intron(P.data(), off.data(), off_end.data(), n_col,
                             ez.max_t, ez.max_q, rev, long_thres, cig);
    }
    return finish(ez, cig, ez_out, cigar_out, cigar_cap);
}

// mm_test_zdrop (align.c:32-89): walk the cigar along the diagonal, find
// the largest diagonal-corrected score drop, optionally probe the dropped
// window for an inversion with the small SW kernel.
extern "C" int32_t mmt_test_zdrop(const uint8_t *qseq, const uint8_t *tseq,
                                  const uint32_t *cigar, int64_t n_cigar,
                                  const int8_t *mat, int32_t q, int32_t e,
                                  int32_t zdrop, int32_t zdrop_inv,
                                  int32_t max_gap, int32_t try_inv,
                                  int32_t min_sc, int32_t min_dp_max) {
    int32_t score = 0, mx = INT32_MIN, max_i = -1, max_j = -1;
    int32_t max_zdrop = 0, i = 0, j = 0;
    int32_t pos[2][2] = {{-1, -1}, {-1, -1}};
    auto upd = [&](int32_t sc, int32_t ii, int32_t jj) {
        if (sc < mx) {
            int32_t li = ii - max_i, lj = jj - max_j;
            int32_t diff = li > lj ? li - lj : lj - li;
            int32_t z = mx - sc - diff * e;
            if (z > max_zdrop) {
                max_zdrop = z;
                pos[0][0] = max_i; pos[0][1] = ii;
                pos[1][0] = max_j; pos[1][1] = jj;
            }
        } else {
            mx = sc; max_i = ii; max_j = jj;
        }
    };
    for (int64_t k = 0; k < n_cigar; ++k) {
        uint32_t op = cigar[k] & 0xF, len = cigar[k] >> 4;
        if (op == 0) {  // M
            for (uint32_t l = 0; l < len; ++l) {
                score += mat[tseq[i + l] * 5 + qseq[j + l]];
                upd(score, i + l, j + l);
            }
            i += len; j += len;
        } else if (op == 1 || op == 2 || op == 3) {  // I/D/N
            score -= q + e * (int32_t)len;
            if (op == 1) j += len; else i += len;
            upd(score, i, j);
        }
    }
    int32_t q_len = pos[1][1] - pos[1][0], t_len = pos[0][1] - pos[0][0];
    if (try_inv && max_zdrop > zdrop_inv && q_len < max_gap
            && t_len < max_gap) {
        std::vector<uint8_t> q2(q_len);
        for (int32_t l = 0; l < q_len; ++l) {
            int c = qseq[pos[1][1] - l - 1];
            q2[l] = c >= 4 ? 4 : 3 - c;
        }
        int32_t qe_ = 0, te_ = 0;
        int32_t sc = mmt_sw_ll(q2.data(), q_len, tseq + pos[0][0], t_len,
                               mat, 5, q, e, &qe_, &te_);
        if (sc >= min_sc && sc >= min_dp_max)
            return 2;
    }
    return max_zdrop > zdrop ? 1 : 0;
}
