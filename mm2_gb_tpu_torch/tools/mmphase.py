"""Read phasing / phased error correction from cs-tagged PAF
(misc/mmphase.js analog, faithful to its output bytes).

Two modes (mmphase.js main, lines ~270-300):
  binning:  mmphase <map-with-cs.paf>            -> SQ/TS/"//" records
  ec:       mmphase <map-with-cs.paf> <reads.fa> -> corrected FASTA

Usage:  python -m mm2_gb_tpu_torch.tools.mmphase [options] <paf> [reads.fa]
"""

from __future__ import annotations

import argparse
import gzip
import re
import sys


def _open(path):
    if path == "-":
        return sys.stdin
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def _p(*args):
    sys.stdout.write("\t".join(map(str, args)) + "\n")


def _read_fastx(f):
    """Single-line-sequence fastx reader (mmphase.js read_fastx)."""
    line = f.readline()
    if not line:
        return None
    m = re.match(r"^([>@])(\S+)", line)
    if m is None:
        raise SystemExit("wrong fastx format")
    seq = f.readline()
    if not seq:
        raise SystemExit("missing sequence line")
    seq = seq.rstrip("\n")
    if m.group(1) == "@":
        f.readline()
        f.readline()
    return [m.group(2), seq]


def _filter_paf(a, opt):
    k = 0
    for ai in a:
        if ai[10] < opt.min_blen:
            continue
        if ai[9] < ai[10] * opt.min_iden:
            continue
        if ai[4] == "+":
            clip = [min(ai[2], ai[7]), min(ai[1] - ai[3], ai[6] - ai[8])]
        else:
            clip = [min(ai[2], ai[6] - ai[8]), min(ai[1] - ai[3], ai[7])]
        if clip[0] > opt.max_clip_len or clip[1] > opt.max_clip_len:
            continue
        a[k] = ai
        k += 1
    del a[k:]


_RE_CS = re.compile(r"(:(\d+))|(([\+\-\*])([a-z]+))")


def _parse_events(t, ev, idx):
    cs = None
    for fld in t[12:]:
        m = re.match(r"^cs:Z:(\S+)", fld)
        if m:
            cs = m.group(1).lower()
            break
    if cs is None:
        sys.stderr.write(f"Warning: no cs tag for read '{t[0]}'\n")
        return
    x = t[2]
    for m in _RE_CS.finditer(cs):
        if m.group(2) is not None:
            ln = int(m.group(2))
            ev.append([x, x + ln, 0, idx])
        elif m.group(4) == "*":
            ln = 1
            ev.append([x, x + 1, 1, idx, m.group(5)[0]])
        elif m.group(4) == "+":
            ln = len(m.group(5))
            ev.append([x, x + ln, 2, idx])
        else:  # '-'
            ln = 0
            ev.append([x, x, -1, idx, m.group(5)])
        x += ln
    if x != t[3]:
        raise SystemExit(f"inconsistent cs for read '{t[0]}'")


def _find_het_sub(ev, a, opt):
    n = len(a)
    last0 = -1
    h = [[] for _ in range(n)]
    d = [[] for _ in range(n)]
    for i, e in enumerate(ev):
        if e[2] == 0:
            if last0 < 0 or e[0] != ev[last0][0]:
                last0 = i
            elif e[1] > ev[last0][1]:
                last0 = i
        elif e[2] == 1 and last0 >= 0 and e[0] < ev[last0][1]:
            if ev[last0][1] - ev[last0][0] >= opt.min_mlen:
                if opt.dbg_ev:
                    _p("EV", "\t".join(map(str, ev[last0])), "|",
                       "\t".join(map(str, e)))
                e0 = ev[last0]
                hl = h[e0[3]]
                if not hl or hl[-1][0] != e0[0]:
                    hl.append([e0[0], e0[1]])
                d[e[3]].append([e[0], e0[1] - e0[0]])
    b = []
    for i in range(n):
        sh = sum(iv[1] - iv[0] for iv in h[i])
        dh = sum(iv[1] for iv in d[i])
        b.append([a[i][2], a[i][3], i, len(h[i]), sh, len(d[i]), dh,
                  a[i][9] / a[i][10], a[i][9]])
    return b


def _flt_utg_for_ec(b, opt):
    k = 0
    for bi in b:
        if bi[4] == 0 and bi[6] == 0:
            b[k] = bi
            k += 1
        elif bi[6] < (bi[4] + bi[6]) * opt.max_ratio0:
            b[k] = bi
            k += 1
    del b[k:]
    if not b:
        return
    b.sort(key=lambda x: x[0])
    st, en = b[0][0], b[0][1]
    max_st = max_en = 0
    max_max_en = en
    for bi in b[1:]:
        if bi[0] > en:
            if en - st > max_en - max_st:
                max_st, max_en = st, en
            st, en = bi[0], bi[1]
        else:
            en = max(en, bi[1])
        max_max_en = max(max_max_en, bi[1])
    if en - st > max_en - max_st:
        max_st, max_en = st, en
    if max_max_en != en or st != b[0][0]:
        k = 0
        for bi in b:
            if bi[0] < max_en and bi[1] > max_st:
                b[k] = bi
                k += 1
        del b[k:]


def _flt_utg_for_bin(b, opt):
    k = 0
    for bi in b:
        if bi[4] + bi[6] == 0 or bi[4] >= (bi[4] + bi[6]) * opt.max_ratio0:
            b[k] = bi
            k += 1
    del b[k:]


def _ec_core(b, n_a, ev, seq):
    intv = [None] * n_a
    intv[b[0][2]] = [b[0][0], b[0][1]]
    en = b[0][1]
    for bi in b[1:]:
        if bi[1] <= en:
            continue
        intv[bi[2]] = [en, bi[1]]
        en = bi[1]
    out = []
    for e in ev:
        iv = intv[e[3]]
        if iv is None:
            continue
        if iv[0] <= e[0] < iv[1]:
            if e[2] == 0:
                out.append(seq[e[0]:e[1]])
            elif e[2] == 1:
                out.append(e[4])
            elif e[2] < 0:
                out.append(e[4])
            # e[2] == 2 (insertion in read): skipped
    return "".join(out)


def _process_paf(a, opt, fp_seq):
    if not a:
        return
    length, name = a[0][1], a[0][0]
    seq = None
    if length < opt.min_rlen:
        return
    if fp_seq is not None:
        while True:
            ret = _read_fastx(fp_seq)
            if ret is None:
                raise SystemExit("failed to find sequence for read "
                                 f"'{a[0][0]}'")
            if ret[0] == a[0][0]:
                break
        name, seq = ret
        if len(seq) != length:
            raise SystemExit(f"inconsistent length for read '{name}'")
    _filter_paf(a, opt)
    if not a:
        return
    ev: list = []
    for i, ai in enumerate(a):
        _parse_events(ai, ev, i)
    ev.sort(key=lambda e: (e[0], e[2]))
    if seq is None:
        _p("SQ", name, a[0][1], len(a))
    b = _find_het_sub(ev, a, opt)
    if opt.ec:
        _flt_utg_for_ec(b, opt)
    else:
        _flt_utg_for_bin(b, opt)
    if seq is None:
        for bi in b:
            ai = a[bi[2]]
            score = 0
            for fld in ai[10:]:
                m = re.match(r"^AS:i:(\d+)", str(fld))
                if m:
                    score = m.group(1)
            _p("TS", bi[2], bi[0], bi[1],
               "\t".join(map(str, ai[5:9])),
               "\t".join(map(str, bi[3:7])), score)
        _p("//")
    else:
        if not b:
            return
        corrected = _ec_core(b, len(a), ev, seq)
        sys.stdout.write(">" + name + "\n" + corrected + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mmphase", add_help=True)
    ap.add_argument("-l", dest="min_rlen", type=int, default=5000)
    ap.add_argument("-b", dest="min_blen", type=int, default=5000)
    ap.add_argument("-d", dest="min_iden", type=float, default=0.8)
    # -m writes opt.min_slen in the reference, which is never read; the
    # effective min match length stays 5 (mmphase.js main ~line 276)
    ap.add_argument("-m", dest="min_slen", type=int, default=None)
    ap.add_argument("-c", dest="max_clip_len", type=int, default=500)
    ap.add_argument("-r", dest="max_ratio0", type=float, default=0.25)
    ap.add_argument("-E", dest="dbg_ev", action="store_true")
    ap.add_argument("paf")
    ap.add_argument("reads", nargs="?", default=None)
    opt = ap.parse_args(sys.argv[1:] if argv is None else argv)
    opt.min_mlen = 5
    opt.ec = opt.reads is not None

    if not opt.ec:
        _p("CC")
        _p("CC", "SQ  qName  qLen    nHits")
        _p("CC", "TS  index  qStart  qEnd  tName  tLen  tStart  tEnd  "
                 "nConsistent  lCons  nConflictive  lConf  score")
        _p("CC")

    fp_seq = _open(opt.reads) if opt.ec else None
    a: list = []
    with _open(opt.paf) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if a and a[0][0] != t[0]:
                _process_paf(a, opt, fp_seq)
                a = []
            for i in range(1, 4):
                t[i] = int(t[i])
            if t[1] < opt.min_rlen:
                continue
            for i in range(6, 11):
                t[i] = int(t[i])
            if t[10] < opt.min_blen:
                continue
            a.append(t)
    _process_paf(a, opt, fp_seq)
    if fp_seq is not None:
        fp_seq.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
