// krmq_avl: exact behavioral emulation of the reference's RMQ-augmented
// AVL tree (krmq.h), index-based clean-room implementation.
//
// Byte parity of --rmq chaining requires reproducing not just the
// min-priority query but its TIE answer, which in the reference depends
// on tree topology (rotation history) and the traversal order of
// krmq_rmq (krmq.h:110-150).  This struct replicates:
//   - lexicographic (y, i) node keys as one composite int64
//   - strict-< priority comparison (lc_elem_lt2, lchain.c:227)
//   - the subtree-min aggregation tie rules of krmq_update_min
//     (krmq.h:154-157), including the direction-dependent argument
//     order at each rotation call site (krmq.h:159-192)
//   - AVL insert with last-imbalanced-node rebalancing and the
//     early-break aggregate update (krmq.h:194-243)
//   - AVL erase incl. the fake-parent walk, the three splice cases and
//     the full-path aggregate refresh (krmq.h:244-330)
//   - the two-path LCA min scan of krmq_rmq (krmq.h:110-150)
//
// No code is copied from krmq.h; the node layout (struct-of-arrays,
// int indices, explicit fake node) and control flow are re-derived from
// the documented behavior above.

#pragma once

#include <cstdint>
#include <vector>

struct KrmqAvl {
    static constexpr int MAXD = 96;  // > 1.44*log2(2^63)

    struct Node {
        int64_t key;   // ((int64)y << 32) | (uint32)i — lc_elem_cmp order
        double pri;
        int ch[2];
        int s;         // subtree min-priority node (head.s analog)
        int8_t bal;
    };

    std::vector<Node> nd;
    std::vector<int> freelist;
    int root = -1;
    int64_t count = 0;

    bool lt2(int a, int b) const { return nd[a].pri < nd[b].pri; }

    // krmq_update_min semantics (krmq.h:154-157): argument ORDER is the
    // tie rule — a's subtree min beats p on tie, b's beats the current.
    void update_min3(int p, int a, int b) {
        int s = (a < 0 || lt2(p, nd[a].s)) ? p : nd[a].s;
        nd[p].s = (b < 0 || lt2(s, nd[b].s)) ? s : nd[b].s;
    }

    int rotate1(int p, int dir) {  // krmq.h:159-170
        int opp = 1 - dir;
        int q = nd[p].ch[opp];
        int s = nd[p].s;
        // update p's aggregate from its POST-rotation children, in the
        // reference's argument order (p->p[dir], q->p[dir])
        int a = nd[p].ch[dir], b = nd[q].ch[dir];
        nd[p].ch[opp] = nd[q].ch[dir];
        update_min3(p, a, b);
        nd[q].s = s;
        nd[q].ch[dir] = p;
        return q;
    }

    int rotate2(int p, int dir) {  // krmq.h:172-192
        int opp = 1 - dir;
        int q = nd[p].ch[opp];
        int r = nd[q].ch[dir];
        int s = nd[p].s;
        int pa = nd[p].ch[dir], pb = nd[r].ch[dir];
        int qa = nd[q].ch[opp], qb = nd[r].ch[opp];
        nd[p].ch[opp] = nd[r].ch[dir];
        update_min3(p, pa, pb);
        nd[q].ch[dir] = nd[r].ch[opp];
        update_min3(q, qa, qb);
        nd[r].s = s;
        nd[r].ch[dir] = p;
        nd[r].ch[opp] = q;
        int8_t b1 = dir == 0 ? +1 : -1;
        if (nd[r].bal == b1) { nd[q].bal = 0; nd[p].bal = -b1; }
        else if (nd[r].bal == 0) { nd[q].bal = nd[p].bal = 0; }
        else { nd[q].bal = b1; nd[p].bal = 0; }
        nd[r].bal = 0;
        return r;
    }

    int alloc(int64_t key, double pri) {
        int x;
        if (!freelist.empty()) {
            x = freelist.back();
            freelist.pop_back();
        } else {
            x = (int)nd.size();
            nd.push_back(Node());
        }
        nd[x].key = key;
        nd[x].pri = pri;
        nd[x].ch[0] = nd[x].ch[1] = -1;
        nd[x].s = x;
        nd[x].bal = 0;
        return x;
    }

    // krmq_insert semantics (krmq.h:194-243); keys are unique here.
    void insert(int64_t key, double pri) {
        int x = alloc(key, pri);
        int path[MAXD];
        unsigned char stack[MAXD];
        int bp = root, bq = -1;
        int p = root, q = -1, top = 0, path_len = 0, which = 0;
        while (p >= 0) {
            int cmp = key < nd[p].key ? -1 : (key > nd[p].key ? 1 : 0);
            if (cmp == 0) { freelist.push_back(x); return; }
            if (nd[p].bal != 0) { bq = q; bp = p; top = 0; }
            which = cmp > 0;
            stack[top++] = (unsigned char)which;
            path[path_len++] = p;
            q = p;
            p = nd[p].ch[which];
        }
        ++count;
        if (q < 0) root = x;
        else nd[q].ch[which] = x;
        if (bp < 0) return;
        for (int i = path_len - 1; i >= 0; --i) {
            update_min3(path[i], nd[path[i]].ch[0], nd[path[i]].ch[1]);
            if (nd[path[i]].s != x) break;
        }
        for (p = bp, top = 0; p != x; p = nd[p].ch[stack[top]], ++top) {
            if (stack[top] == 0) --nd[p].bal;
            else ++nd[p].bal;
        }
        if (nd[bp].bal > -2 && nd[bp].bal < 2) return;
        int w = nd[bp].bal < 0;
        int8_t b1 = w == 0 ? +1 : -1;
        int qq = nd[bp].ch[1 - w];
        int r;
        if (nd[qq].bal == b1) {
            r = rotate1(bp, w);
            nd[qq].bal = nd[bp].bal = 0;
        } else {
            r = rotate2(bp, w);
        }
        if (bq < 0) root = r;
        else nd[bq].ch[bp != nd[bq].ch[0]] = r;
    }

    // krmq_erase semantics (krmq.h:244-330); returns true if found.
    bool erase(int64_t key) {
        if (root < 0) return false;
        int path[MAXD];
        unsigned char dir[MAXD];
        int d = 0;
        int fake = alloc(nd[root].key, nd[root].pri);  // fake = *root copy
        nd[fake].ch[0] = root;
        nd[fake].ch[1] = -1;
        nd[fake].bal = nd[root].bal;
        int p = fake;
        int cmp = -1;
        while (cmp != 0) {
            int which = cmp > 0;
            dir[d] = (unsigned char)which;
            path[d++] = p;
            p = nd[p].ch[which];
            if (p < 0) { freelist.push_back(fake); return false; }
            cmp = key < nd[p].key ? -1 : (key > nd[p].key ? 1 : 0);
        }
        --count;
        if (nd[p].ch[1] < 0) {
            nd[path[d - 1]].ch[dir[d - 1]] = nd[p].ch[0];
        } else {
            int q = nd[p].ch[1];
            if (nd[q].ch[0] < 0) {
                nd[q].ch[0] = nd[p].ch[0];
                nd[q].bal = nd[p].bal;
                nd[path[d - 1]].ch[dir[d - 1]] = q;
                path[d] = q;
                dir[d++] = 1;
            } else {
                int e = d++;  // backup d
                int r;
                for (;;) {
                    dir[d] = 0;
                    path[d++] = q;
                    r = nd[q].ch[0];
                    if (nd[r].ch[0] < 0) break;
                    q = r;
                }
                nd[r].ch[0] = nd[p].ch[0];
                nd[q].ch[0] = nd[r].ch[1];
                nd[r].ch[1] = nd[p].ch[1];
                nd[r].bal = nd[p].bal;
                nd[path[e - 1]].ch[dir[e - 1]] = r;
                path[e] = r;
                dir[e] = 1;
            }
        }
        for (int i = d - 1; i >= 0; --i)
            update_min3(path[i], nd[path[i]].ch[0], nd[path[i]].ch[1]);
        while (--d > 0) {
            int q = path[d];
            int which = dir[d], other = 1 - which;
            int8_t b1 = 1, b2 = 2;
            if (which) { b1 = -b1; b2 = -b2; }
            nd[q].bal += b1;
            if (nd[q].bal == b1) break;
            if (nd[q].bal == b2) {
                int r = nd[q].ch[other];
                if (nd[r].bal == -b1) {
                    nd[path[d - 1]].ch[dir[d - 1]] = rotate2(q, which);
                } else {
                    nd[path[d - 1]].ch[dir[d - 1]] = rotate1(q, which);
                    if (nd[r].bal == 0) {
                        nd[r].bal = -b1;
                        nd[q].bal = b1;
                        break;
                    }
                    nd[r].bal = nd[q].bal = 0;
                }
            }
        }
        root = nd[fake].ch[0];
        freelist.push_back(fake);
        freelist.push_back(p);
        return true;
    }

    // krmq_rmq semantics (krmq.h:110-150): min-priority node with key in
    // the CLOSED interval [lo, up]; tie answers follow the exact
    // two-path traversal order.  Returns node index or -1.
    int rmq(int64_t lo, int64_t up) const {
        if (root < 0) return -1;
        const int64_t bound[2] = {lo, up};
        int path[2][MAXD];
        int pcmp[2][MAXD];
        int plen[2] = {0, 0};
        for (int w = 0; w < 2; ++w) {
            int p = root;
            while (p >= 0) {
                int64_t k = bound[w];
                int cmp = k < nd[p].key ? -1 : (k > nd[p].key ? 1 : 0);
                path[w][plen[w]] = p;
                pcmp[w][plen[w]++] = cmp;
                if (cmp == 0) break;
                p = nd[p].ch[cmp > 0];
            }
        }
        int i;
        for (i = 0; i < plen[0] && i < plen[1]; ++i)
            if (path[0][i] == path[1][i] && pcmp[0][i] <= 0
                && pcmp[1][i] >= 0)
                break;
        if (i == plen[0] || i == plen[1]) return -1;
        int lca = i;
        int mn = path[0][lca];
        for (i = lca + 1; i < plen[0]; ++i) {
            if (pcmp[0][i] <= 0) {
                if (lt2(path[0][i], mn)) mn = path[0][i];
                int rc = nd[path[0][i]].ch[1];
                if (rc >= 0 && lt2(nd[rc].s, mn)) mn = nd[rc].s;
            }
        }
        for (i = lca + 1; i < plen[1]; ++i) {
            if (pcmp[1][i] >= 0) {
                if (lt2(path[1][i], mn)) mn = path[1][i];
                int lc = nd[path[1][i]].ch[0];
                if (lc >= 0 && lt2(nd[lc].s, mn)) mn = nd[lc].s;
            }
        }
        return mn;
    }
};
