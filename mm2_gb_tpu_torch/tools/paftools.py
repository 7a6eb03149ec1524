"""PAF toolkit subset (misc/paftools.js analog).

Implements the accuracy-evaluation subcommands the reference uses in its
papers (misc/README.md): `mapeval` (ROC over MAPQ from simulated-read
names, paftools.js:2040-2166) and `stat` (alignment statistics,
paftools.js:963-1140).  Both accept PAF or SAM.

Usage:  python -m mm2_gb_tpu_torch.tools.paftools <subcommand> [options] <file>

Subcommands: mapeval, stat, sam2paf (paftools.js:1695), liftover
(paftools.js:206), call (paftools.js:340), view (paftools.js:1365).
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


def _p(*args, file=None):
    """k8 print(): arguments joined by TAB (see misc/README.md examples)."""
    (file or sys.stdout).write("\t".join(map(str, args)) + "\n")


_RE_PBSIM = re.compile(r"^(\S+)!(\S+)!(\d+)!(\d+)!([\+\-])$")
_RE_MASON = re.compile(
    r"^(\S+)!(\S+)!(\d+)_(\d+)!(\d+)_(\d+)!([\+\-])([\+\-])/([12])$")
_RE_CIGAR = re.compile(r"(\d+)([MIDSHNX=])")


def _parse_truth(qname: str):
    m = _RE_PBSIM.match(qname)
    if m:
        return [m.group(2), int(m.group(3)), int(m.group(4)), m.group(5)]
    m = _RE_MASON.match(qname)
    if m:
        if m.group(9) == "1":
            return [m.group(2), int(m.group(3)), int(m.group(5)), m.group(7)]
        return [m.group(2), int(m.group(4)), int(m.group(6)), m.group(8)]
    raise SystemExit(f"Failed to parse simulated read name '{qname}'")


def mapeval(argv) -> int:
    ap = argparse.ArgumentParser(prog="paftools mapeval")
    ap.add_argument("-r", dest="ovlp_ratio", type=float, default=0.1)
    ap.add_argument("-Q", dest="err_out_q", type=int, default=None)
    ap.add_argument("-m", dest="mode", type=int, default=0)
    ap.add_argument("input")
    args = ap.parse_args(argv)
    err_out_q = 256 if args.err_out_q is None else args.err_out_q
    max_mapq = 60
    tot = [0] * (max_mapq + 1)
    err = [0] * (max_mapq + 1)
    n_unmapped = None

    def is_correct(s, b) -> bool:
        # overlap/union > ovlp_ratio on the same chr+strand
        if s[0] != b[0] or s[3] != b[3]:
            return False
        if s[1] < b[1]:
            if s[2] <= b[1]:
                return False
            o = min(s[2], b[2]) - b[1]
            l = max(s[2], b[2]) - s[1]
        else:
            if b[2] <= s[1]:
                return False
            o = min(s[2], b[2]) - s[1]
            l = max(s[2], b[2]) - b[1]
        return o / l > args.ovlp_ratio

    def count(qname, a):
        if not a:
            return
        s = _parse_truth(qname)
        if args.mode in (0, 1):
            max_i = 0
            if args.mode == 0:  # longest alignment only
                mx = 0
                for i, r in enumerate(a):
                    if r[5] > mx:
                        mx, max_i = r[5], i
            mapq = a[max_i][4]
            tot[mapq] += 1
            if not is_correct(s, a[max_i]):
                if mapq >= err_out_q:
                    _p("E", qname, "\t".join(map(str, a[max_i])))
                err[mapq] += 1
        else:  # all primary alignments
            max_err_mapq, mx_mapq, max_err_i = -1, 0, -1
            for i, r in enumerate(a):
                mx_mapq = max(mx_mapq, r[4])
                if not is_correct(s, r) and r[4] > max_err_mapq:
                    max_err_mapq, max_err_i = r[4], i
            if max_err_mapq >= 0:
                tot[max_err_mapq] += 1
                err[max_err_mapq] += 1
                if max_err_mapq >= err_out_q:
                    _p("E", qname, "\t".join(map(str, a[max_err_i])))
            else:
                tot[mx_mapq] += 1

    last = None
    a: list = []
    with _open(args.input) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line[0] == "@":
                continue
            t = line.split("\t")
            if len(t) > 4 and t[4] in "+-":  # PAF
                if last != t[0]:
                    if last is not None:
                        count(last, a)
                    a, last = [], t[0]
                if re.search(r"\ts1:i:\d+", line) and \
                        not re.search(r"\ts2:i:\d+", line):
                    continue  # secondary
                mapq = min(int(t[11]), max_mapq)
                a.append([t[5], int(t[7]), int(t[8]), t[4], mapq, int(t[9])])
            else:  # SAM
                flag = int(t[1])
                read_no = flag >> 6 & 0x3
                qname = t[0]
                if not re.search(r"/[12]$", qname) and read_no in (1, 2):
                    qname = f"{t[0]}/{read_no}"
                if last != qname:
                    if last is not None:
                        count(last, a)
                    a, last = [], qname
                if flag & 0x100:
                    continue
                if (flag & 0x4) or t[2] == "*":
                    n_unmapped = (n_unmapped or 0) + 1
                    continue
                mapq = min(int(t[4]), max_mapq)
                pos = int(t[3]) - 1
                pos_end = pos
                n_gap = mlen = 0
                for m in _RE_CIGAR.finditer(t[5]):
                    ln = int(m.group(1))
                    op = m.group(2)
                    if op == "M":
                        pos_end += ln
                        mlen += ln
                    elif op == "I":
                        n_gap += ln
                    elif op == "D":
                        n_gap += ln
                        pos_end += ln
                score = pos_end - pos
                m = re.search(r"\tNM:i:(\d+)", line)
                if m:
                    nm = int(m.group(1))
                    if nm >= n_gap:
                        score = mlen - (nm - n_gap)
                a.append([t[2], pos, pos_end, "-" if flag & 16 else "+",
                          mapq, score])
    if last is not None:
        count(last, a)

    sum_tot = sum_err = 0
    sum_tot2 = sum_err2 = 0
    q_out = -1
    for q in range(max_mapq, -1, -1):
        if tot[q] == 0:
            continue
        if q_out < 0 or err[q] > 0:
            if q_out >= 0:
                _p("Q", q_out, sum_tot, sum_err,
                   f"{sum_err2 / sum_tot2:.9f}", sum_tot2)
            sum_tot = sum_err = 0
            q_out = q
        sum_tot += tot[q]
        sum_err += err[q]
        sum_tot2 += tot[q]
        sum_err2 += err[q]
    _p("Q", q_out, sum_tot, sum_err, f"{sum_err2 / sum_tot2:.9f}",
       sum_tot2)
    if n_unmapped is not None:
        _p("U", n_unmapped)
    return 0


def stat(argv) -> int:
    ap = argparse.ArgumentParser(prog="paftools stat")
    ap.add_argument("-l", dest="gap_out_len", type=int, default=None)
    ap.add_argument("input")
    args = ap.parse_args(argv)

    n_pri = n_2nd = n_seq = n_cigar_64k = l_tot = l_cov = n_sub = 0
    n_gap = [[0] * 6, [0] * 6]

    def cov_len(regs):
        regs.sort()
        st, en = regs[0]
        l = 0
        for s, e in regs[1:]:
            if s < en:
                en = max(en, e)
            else:
                l += en - st
                st, en = s, e
        return l + en - st

    last = None
    last_qlen = None
    regs: list = []
    with _open(args.input) as f:
        for lineno, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line or line[0] == "@":
                continue
            t = line.split("\t")
            if len(t) < 2:
                continue
            NM = None
            nn = 0
            is_sam = False
            atlen = None
            if len(t) > 4 and t[4] in "+-*":  # PAF
                if t[4] == "*":
                    continue
                if not re.search(r"\ts2:i:\d+", line):
                    n_2nd += 1
                    continue
                m = re.search(r"\tNM:i:(\d+)", line)
                NM = int(m.group(1)) if m else None
                m = re.search(r"\tnn:i:(\d+)", line)
                nn = int(m.group(1)) if m else 0
                m = re.search(r"\tcg:Z:(\S+)", line)
                if not m:
                    sys.stderr.write(f"WARNING: no CIGAR at line {lineno}\n")
                    continue
                cigar = m.group(1)
                tname = t[5]
                qs, qe = int(t[2]), int(t[3])
                aqlen = qe - qs
                is_rev = t[4] == "-"
                rs = int(t[7])
                atlen = int(t[8]) - rs
                ori_qlen = int(t[1])
            else:  # SAM
                flag = int(t[1])
                if (flag & 4) or t[2] == "*" or t[5] == "*":
                    continue
                if flag & 0x100:
                    n_2nd += 1
                    continue
                m = re.search(r"\tNM:i:(\d+)", line)
                NM = int(m.group(1)) if m else None
                m = re.search(r"\tnn:i:(\d+)", line)
                nn = int(m.group(1)) if m else 0
                cigar = t[5]
                tname = t[2]
                rs = int(t[3]) - 1
                aqlen = len(t[9])
                is_sam = True
                is_rev = bool(flag & 0x10)
            n_pri += 1
            if last != t[0]:
                if last is not None:
                    l_tot += last_qlen
                    l_cov += cov_len(regs)
                regs = []
                n_seq += 1
                last = t[0]
            M = tl = ql = sclip = n_cigar = 0
            clip = [0, 0]
            n_gapo = n_gap_all = 0
            for m in _RE_CIGAR.finditer(cigar):
                ln = int(m.group(1))
                op = m.group(2)
                n_cigar += 1
                if op in "M=X":
                    tl += ln
                    ql += ln
                    M += ln
                elif op in "ID":
                    typ = (0 if ln < 50 else 1 if ln < 100 else 2
                           if ln < 300 else 3 if ln < 400 else 4
                           if ln < 1000 else 5)
                    if op == "I":
                        ql += ln
                        n_gap[0][typ] += 1
                    else:
                        tl += ln
                        n_gap[1][typ] += 1
                    if args.gap_out_len is not None and ln >= args.gap_out_len:
                        _p(t[0], ql, "-" if is_rev else "+", tname,
                           rs + tl, op, ln)
                    n_gapo += 1
                    n_gap_all += ln
                elif op == "N":
                    tl += ln
                elif op == "S":
                    clip[0 if M == 0 else 1] = ln
                    sclip += ln
                elif op == "H":
                    clip[0 if M == 0 else 1] = ln
            if NM is not None:
                n_sub += max(NM - n_gap_all - nn, 0)
            if n_cigar > 65535:
                n_cigar_64k += 1
            if is_sam:
                qs = clip[1 if is_rev else 0]
                qe = qs + ql
                ori_qlen = clip[0] + ql + clip[1]
            regs.append([qs, qe])
            last_qlen = ori_qlen
    if regs:
        l_tot += last_qlen
        l_cov += cov_len(regs)

    if args.gap_out_len is None:
        print(f"Number of mapped sequences: {n_seq}")
        print(f"Number of primary alignments: {n_pri}")
        print(f"Number of secondary alignments: {n_2nd}")
        print("Number of primary alignments with >65535 CIGAR operations: "
              f"{n_cigar_64k}")
        print(f"Number of bases in mapped sequences: {l_tot}")
        print(f"Number of mapped bases: {l_cov}")
        print(f"Number of substitutions: {n_sub}")
        for gi, what in ((0, "insertions"), (1, "deletions")):
            for typ, rng in enumerate(("[0,50)", "[50,100)", "[100,300)",
                                       "[300,400)", "[400,1000)",
                                       "[1000,inf)")):
                print(f"Number of {what} in {rng}: {n_gap[gi][typ]}")
    return 0




# ------------------------------------------------------------------ sam2paf
_RE_MD = re.compile(r"(\d+)|(\^[A-Za-z]+)|([A-Za-z])")
_RE_TAG = re.compile(r"\t(\S\S:[AZif]):(\S+)")


def sam2paf(argv) -> int:
    """SAM -> PAF conversion (paf_sam2paf, paftools.js:1695-1855)."""
    ap = argparse.ArgumentParser(prog="paftools sam2paf")
    ap.add_argument("-p", dest="pri_only", action="store_true",
                    help="primary/supplementary only")
    ap.add_argument("-L", dest="long_cs", action="store_true",
                    help="long-form cs")
    ap.add_argument("sam")
    args = ap.parse_args(argv)
    ctg_len: dict[str, int] = {}
    lineno = 0
    out = sys.stdout
    for line in _open(args.sam):
        line = line.rstrip("\n")
        lineno += 1
        if line.startswith("@"):
            if line.startswith("@SQ"):
                mn = re.search(r"\tSN:(\S+)", line)
                ml = re.search(r"\tLN:(\d+)", line)
                if mn and ml:
                    ctg_len[mn.group(1)] = int(ml.group(1))
            continue
        t = line.split("\t", 11)
        flag = int(t[1])
        if t[9] != "*" and t[10] != "*" and len(t[9]) != len(t[10]):
            raise SystemExit(f"line {lineno}: inconsistent SEQ/QUAL lengths")
        if t[2] == "*" or (flag & 4) or t[5] == "*":
            continue
        if args.pri_only and (flag & 0x100):
            continue
        if t[2] not in ctg_len:
            raise SystemExit(f"line {lineno}: no length for contig {t[2]}")
        tlen_ctg = ctg_len[t[2]]
        nn, NM, MD, cs_str = 0, None, None, None
        for m in _RE_TAG.finditer("\t" + "\t".join(line.split("\t")[11:])):
            if m.group(1) == "NM:i":
                NM = int(m.group(2))
            elif m.group(1) == "nn:i":
                nn = int(m.group(2))
            elif m.group(1) == "MD:Z":
                MD = m.group(2)
            elif m.group(1) == "cs:Z":
                cs_str = m.group(2)
        if t[9] == "*":
            MD = cs_str = None
        clip = [0, 0]
        soft_clip = 0
        I = [0, 0]
        D = [0, 0]
        M = N = mm = 0
        have_M = have_ext = False
        cigar = []
        n_cigar = 0
        for m in _RE_CIGAR.finditer(t[5]):
            ln, op = int(m.group(1)), m.group(2)
            if op == "M":
                M += ln
                have_M = True
            elif op == "I":
                I[0] += 1
                I[1] += ln
            elif op == "D":
                D[0] += 1
                D[1] += ln
            elif op == "N":
                N += ln
            elif op == "S":
                clip[0 if n_cigar == 0 else 1] = ln
                soft_clip += ln
            elif op == "H":
                clip[0 if n_cigar == 0 else 1] = ln
            elif op == "=":
                M += ln
                have_ext = True
                op = "M"
            elif op == "X":
                M += ln
                mm += ln
                have_ext = True
                op = "M"
            n_cigar += 1
            if MD is not None and op != "H":
                if cigar and cigar[-1][1] == op:
                    cigar[-1][0] += ln
                else:
                    cigar.append([ln, op])
        ql = M + I[1] + soft_clip
        tl = M + D[1] + N
        ts = int(t[3]) - 1
        te = ts + tl
        if n_cigar > 65535:
            sys.stderr.write(f"WARNING line {lineno}: {n_cigar} CIGAR ops\n")
        if te > tlen_ctg:
            sys.stderr.write(f"WARNING line {lineno}: end > ref length; "
                             "skipped\n")
            continue
        if t[9] != "*" and len(t[9]) != ql:
            sys.stderr.write(f"WARNING line {lineno}: SEQ length "
                             f"inconsistent with CIGAR; skipped\n")
            continue
        # reconstruct cs from MD (paftools.js:1777-1815)
        cs: list[str] = []
        if MD is not None and cs_str is None and t[9] != "*":
            k = cx = cy = mx = my = 0
            ok = True
            for m in _RE_MD.finditer(MD):
                if m.group(2) is not None:
                    dln = len(m.group(2)) - 1
                    cs += ["-", m.group(2)[1:]]
                    mx += dln
                    cx += dln
                    k += 1
                else:
                    ml = int(m.group(1)) if m.group(1) is not None else 1
                    while k < len(cigar) and cigar[k][1] != "D":
                        cl, op = cigar[k]
                        if op == "M":
                            if my + ml < cy + cl:
                                if ml > 0:
                                    if m.group(3) is not None:
                                        cs += ["*", m.group(3), t[9][my]]
                                    elif args.long_cs:
                                        cs += ["=", t[9][my:my + ml]]
                                    else:
                                        cs += [":", str(ml)]
                                mx += ml
                                my += ml
                                ml = 0
                                break
                            dl = cy + cl - my
                            if args.long_cs:
                                cs += ["=", t[9][my:my + dl]]
                            else:
                                cs += [":", str(dl)]
                            cx += cl
                            cy += cl
                            k += 1
                            mx += dl
                            my += dl
                            ml -= dl
                        elif op == "I":
                            cs += ["+", t[9][cy:cy + cl]]
                            cy += cl
                            my += cl
                            k += 1
                        elif op == "S":
                            cy += cl
                            my += cl
                            k += 1
                        else:
                            raise SystemExit(
                                f"line {lineno}: inconsistent MD tag")
                    if ml != 0:
                        raise SystemExit(f"line {lineno}: inconsistent MD")
            if cx != mx or cy != my:
                raise SystemExit(f"line {lineno}: inconsistent MD tag")
        if have_ext and not have_M:
            if NM is not None and NM != I[1] + D[1] + mm:
                sys.stderr.write(f"WARNING line {lineno}: NM != gaps+mm\n")
            NM = I[1] + D[1] + mm
        elif NM is not None:
            if NM < I[1] + D[1]:
                sys.stderr.write(f"WARNING line {lineno}: NM < gaps\n")
                NM = I[1] + D[1]
            mm = NM - (I[1] + D[1])
        else:
            sys.stderr.write(f"WARNING line {lineno}: no NM; assuming 0 "
                             "mismatches\n")
            mm = 0
        mlen = M - mm
        blen = M + I[1] + D[1]
        qlen = M + I[1] + clip[0] + clip[1]
        qname = t[0]
        if (flag & 1) and (flag & 0x40):
            qname += "/1"
        if (flag & 1) and (flag & 0x80):
            qname += "/2"
        if flag & 16:
            qs, qe = clip[1], qlen - clip[0]
        else:
            qs, qe = clip[0], qlen - clip[1]
        tags = ["tp:A:" + ("S" if flag & 0x100 else "P")]
        if NM is not None:
            tags.append(f"mm:i:{mm}")
        tags += [f"gn:i:{I[1] + D[1]}", f"go:i:{I[0] + D[0]}",
                 "cg:Z:" + re.sub(r"\d+[SH]", "", t[5])]
        if cs_str is not None:
            tags.append("cs:Z:" + cs_str)
        elif cs:
            tags.append("cs:Z:" + "".join(cs))
        a = [qname, qlen, qs, qe, "-" if flag & 16 else "+", t[2],
             tlen_ctg, ts, te, mlen, blen, t[4]]
        out.write("\t".join(map(str, a)) + "\t" + "\t".join(tags) + "\n")
    return 0


# ----------------------------------------------------------------- liftover
def _read_bed(fn, to_merge):
    bed: dict[str, list] = {}
    for line in _open(fn):
        f = line.rstrip("\n").split("\t")
        bed.setdefault(f[0], []).append([int(f[1]), int(f[2])])
    for chrom in bed:
        ivs = sorted(bed[chrom])
        if to_merge:
            merged = []
            for iv in ivs:
                if merged and iv[0] <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], iv[1])
                else:
                    merged.append(iv)
            ivs = merged
        bed[chrom] = ivs
    return bed


_RE_CG_MID = re.compile(r"(\d+)([MID])")


def liftover(argv) -> int:
    """Lift BED intervals through PAF (paf_liftover, paftools.js:206-338)."""
    ap = argparse.ArgumentParser(prog="paftools liftover")
    ap.add_argument("-m", dest="merge", action="store_true")
    ap.add_argument("-q", dest="min_mapq", type=int, default=5)
    ap.add_argument("-l", dest="min_len", type=int, default=50000)
    ap.add_argument("-d", dest="max_div", type=float, default=2.0)
    ap.add_argument("paf")
    ap.add_argument("bed")
    args = ap.parse_args(argv)
    bed = _read_bed(args.bed, args.merge)
    out = sys.stdout
    for line in _open(args.paf):
        t = line.rstrip("\n").split("\t")
        if t[0] not in bed:
            continue
        tp = cg = None
        for fld in t[12:]:
            if fld.startswith("tp:A:"):
                tp = fld[5:]
            elif fld.startswith("cg:Z:"):
                cg = fld[5:]
        if tp not in ("P", "I"):
            continue
        if cg is None:
            raise SystemExit("unable to find the 'cg' tag")
        qlen, qs, qe = int(t[1]), int(t[2]), int(t[3])
        tlen_, ts, te, mlen, blen, mapq = (int(t[i]) for i in range(6, 12))
        if mapq < args.min_mapq or blen < args.min_len:
            continue
        regs = [iv for iv in bed[t[0]] if iv[0] < qe and qs < iv[1]]
        if not regs:
            continue
        if 0.0 <= args.max_div < 1.0:
            n_gaps = n_opens = 0
            for m in _RE_CG_MID.finditer(cg):
                if m.group(2) in "ID":
                    n_gaps += int(m.group(1))
                    n_opens += 1
            n_mm = blen - mlen - n_gaps
            n_diff2 = n_mm + n_opens
            if n_diff2 / (n_diff2 + mlen) > args.max_div:
                continue
        strand = t[4]
        a = []
        r = [[-2, -2] for _ in regs]
        for i, (s0, e0) in enumerate(regs):
            if strand == "+":
                a.append([s0, 0, i, -2])
                a.append([e0 - 1, 1, i, -2])
            else:
                a.append([qlen - e0, 0, i, -2])
                a.append([qlen - s0 - 1, 1, i, -2])
        a.sort(key=lambda z: z[0])
        k = 0
        x = ts
        y = qs if strand == "+" else qlen - qe
        for m in _RE_CG_MID.finditer(cg):
            ln, op = int(m.group(1)), m.group(2)
            if op == "D":
                x += ln
                continue
            while k < len(a) and a[k][0] < y:
                k += 1
            for i in range(k, len(a)):
                if y <= a[i][0] < y + ln:
                    a[i][3] = x + (a[i][0] - y) if op == "M" else x
                else:
                    break
            y += ln
            if op == "M":
                x += ln
        if x != te or (strand == "+" and y != qe) \
                or (strand == "-" and y != qlen - qs):
            raise SystemExit("CIGAR is inconsistent with mapping coords")
        for pos, which, i, lifted in a:
            if which == 0:
                r[i][0] = lifted
            else:
                r[i][1] = lifted + 1
        for i, (s0, e0) in enumerate(regs):
            name = f"{t[0]}_{s0}_{e0}"
            if r[i][0] < 0:
                name += "_t5"
                r[i][0] = ts
            if r[i][1] < 0:
                name += "_t3"
                r[i][1] = te
            out.write(f"{t[5]}\t{r[i][0]}\t{r[i][1]}\t{name}\t0"
                      f"\t{strand}\n")
    return 0


# --------------------------------------------------------------------- call
_RE_CS_OP = re.compile(r"([:=*+-])(\d+|[A-Za-z]+)")


def call(argv) -> int:
    """Variant calling from coord-sorted cs PAF (paf_call,
    paftools.js:340-566).  Text output ('R'/'V' records) or VCF with -f."""
    ap = argparse.ArgumentParser(prog="paftools call")
    ap.add_argument("-l", dest="min_cov_len", type=int, default=10000)
    ap.add_argument("-L", dest="min_var_len", type=int, default=50000)
    ap.add_argument("-g", dest="gap_thres", type=int, default=50)
    ap.add_argument("-G", dest="gap_thres_long", type=int, default=1000)
    ap.add_argument("-q", dest="min_mapq", type=int, default=5)
    ap.add_argument("-f", dest="fasta", default=None)
    ap.add_argument("-s", dest="sample", default="sample")
    ap.add_argument("paf")
    args = ap.parse_args(argv)
    out = sys.stdout
    fa = None
    if args.fasta:
        from mm2_gb_tpu_torch.utils.fastx import read_fastx
        fa = {}
        fa_lens = []
        for rec in read_fastx(args.fasta):
            fa[rec.name] = rec.seq
            fa_lens.append((rec.name, len(rec.seq)))
        out.write("##fileformat=VCFv4.1\n")
        for nm, ln in fa_lens:
            out.write(f"##contig=<ID={nm},length={ln}>\n")
        out.write('##INFO=<ID=QNAME,Number=1,Type=String,'
                  'Description="Query name">\n')
        out.write('##INFO=<ID=QSTART,Number=1,Type=Integer,'
                  'Description="Query start">\n')
        out.write('##INFO=<ID=QSTRAND,Number=1,Type=String,'
                  'Description="Query strand">\n')
        out.write('##FORMAT=<ID=GT,Number=1,Type=String,'
                  'Description="Genotype">\n')
        out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
                  f"\tFORMAT\t{args.sample}\n")

    n_sub = [0, 0, 0]
    n_ins = [0] * 5
    n_del = [0] * 5

    def emit(o):
        # o: [ctg, st, en, cov, mapq, ref, alt, qname, qs, qe, strand]
        if o[3] <= 1 and not (o[5] == "-" and o[6] == "-"):
            if o[5] == "-":
                ln = len(o[6])
                n_ins[0 if ln == 1 else 1 if ln == 2 else
                      2 if ln < args.gap_thres else
                      3 if ln < args.gap_thres_long else 4] += 1
            elif o[6] == "-":
                ln = len(o[5])
                n_del[0 if ln == 1 else 1 if ln == 2 else
                      2 if ln < args.gap_thres else
                      3 if ln < args.gap_thres_long else 4] += 1
            else:
                n_sub[0] += 1
                pair2 = (o[5] + o[6]).lower()
                if pair2 in ("ag", "ga", "ct", "tc"):
                    n_sub[1] += 1
                else:
                    n_sub[2] += 1
        if fa is None:
            out.write("V\t" + "\t".join(map(str, o)) + "\n")
            return
        if o[3] != 1 or (o[5] == "-" and o[6] == "-"):
            return
        if o[5] != "-" and o[6] != "-":
            v = [o[0], o[1] + 1, ".", o[5].upper(), o[6].upper()]
        elif o[1] > 0:
            ref = fa[o[0]][o[1] - 1].upper()
            if o[5] == "-":
                v = [o[0], o[1], ".", ref, ref + o[6].upper()]
            else:
                v = [o[0], o[1], ".", ref + o[5].upper(), ref]
        else:
            return
        v += [o[4], ".", f"QNAME={o[7]};QSTART={o[8] + 1};QSTRAND={o[10]}",
              "GT", "1/1"]
        out.write("\t".join(map(str, v)) + "\n")

    a: list = []
    pend: list = []
    c1_ctg, c1_start, c1_end, c1_counted, c1_len = None, 0, 0, False, 0
    for line in _open(args.paf):
        line = line.rstrip("\n")
        t = line.split("\t")
        if len(t) < 12 or t[5] == "*":
            continue
        blen, mapq = int(t[10]), int(t[11])
        if blen < args.min_cov_len or mapq < args.min_mapq:
            continue
        qlen, qs_f, qe_f = int(t[1]), int(t[2]), int(t[3])
        ctg, x, end = t[5], int(t[7]), int(t[8])
        query, rev = t[0], t[4] == "-"
        y = qe_f if rev else qs_f
        cs = tp = None
        have_s1 = have_s2 = False
        for fld in t[12:]:
            if fld.startswith("cs:Z:"):
                cs = fld[5:]
            elif fld.startswith("tp:A:"):
                tp = fld[5:]
            elif fld.startswith("s1:i:"):
                have_s1 = True
            elif fld.startswith("s2:i:"):
                have_s2 = True
        if have_s1 and not have_s2:
            continue
        if tp in ("S", "i"):
            continue
        if ctg != c1_ctg or x >= c1_end:
            if c1_counted and c1_end > c1_start:
                c1_len += c1_end - c1_start
                if fa is None:
                    out.write(f"R\t{c1_ctg}\t{c1_start}\t{c1_end}\n")
            c1_ctg, c1_start, c1_end = ctg, x, end
            c1_counted = blen >= args.min_var_len
        elif end > c1_end:
            if c1_counted and x > c1_start:
                c1_len += x - c1_start
                if fa is None:
                    out.write(f"R\t{c1_ctg}\t{c1_start}\t{x}\n")
            c1_start, c1_end = c1_end, end
            c1_counted = blen >= args.min_var_len
        elif end > c1_start:
            if c1_counted and x > c1_start:
                c1_len += x - c1_start
                if fa is None:
                    out.write(f"R\t{c1_ctg}\t{c1_start}\t{x}\n")
            c1_start = end
        while pend:
            if pend[0][0] != ctg or pend[0][2] <= x:
                emit(pend.pop(0))
            else:
                break
        for o in pend:
            if o[1] >= x and o[2] <= end:
                o[3] += 1
        a = [z for z in a if z[0] == ctg and z[2] > x]
        if blen >= args.min_var_len and cs is not None:
            for m in _RE_CS_OP.finditer(cs):
                op, val = m.group(1), m.group(2)
                if op in "*+-":
                    cov = 1 + sum(1 for z in a if z[2] > x)
                if op in ":=":
                    ln = len(val) if op == "=" else int(val)
                    y = y - ln if rev else y + ln
                    x += ln
                elif op == "*":
                    if rev:
                        qs, qe = y - 1, y
                        y -= 1
                    else:
                        qs, qe = y, y + 1
                        y += 1
                    br, bq = val[0], val[1]
                    if br != "n" and bq != "n":
                        pend.append([ctg, x, x + 1, cov, mapq, br, bq,
                                     query, qs, qe, "-" if rev else "+"])
                    x += 1
                elif op == "+":
                    ln = len(val)
                    if rev:
                        qs, qe = y - ln, y
                        y -= ln
                    else:
                        qs, qe = y, y + ln
                        y += ln
                    pend.append([ctg, x, x, cov, mapq, "-", val, query,
                                 qs, qe, "-" if rev else "+"])
                elif op == "-":
                    ln = len(val)
                    pend.append([ctg, x, x + ln, cov, mapq, val, "-",
                                 query, y, y, "-" if rev else "+"])
                    x += ln
        a.append([ctg, int(t[7]), int(t[8])])
    if c1_counted and c1_end > c1_start:
        c1_len += c1_end - c1_start
        if fa is None:
            out.write(f"R\t{c1_ctg}\t{c1_start}\t{c1_end}\n")
    while pend:
        emit(pend.pop(0))
    w = sys.stderr.write
    w(f"{c1_len} reference bases covered by exactly one contig\n")
    if n_sub[2]:
        tstv = f"{n_sub[1] / n_sub[2]:.3f}"
    else:  # JS 1/0 -> Infinity, 0/0 -> NaN
        tstv = "Infinity" if n_sub[1] else "NaN"
    w(f"{n_sub[0]} substitutions; ts/tv = {tstv}\n")
    w(f"{n_del[0]} 1bp deletions\n")
    w(f"{n_ins[0]} 1bp insertions\n")
    w(f"{n_del[1]} 2bp deletions\n")
    w(f"{n_ins[1]} 2bp insertions\n")
    w(f"{n_del[2]} [3,{args.gap_thres}) deletions\n")
    w(f"{n_ins[2]} [3,{args.gap_thres}) insertions\n")
    w(f"{n_del[3]} [{args.gap_thres},{args.gap_thres_long}) deletions\n")
    w(f"{n_ins[3]} [{args.gap_thres},{args.gap_thres_long}) insertions\n")
    w(f"{n_del[4]} >={args.gap_thres_long} deletions\n")
    w(f"{n_ins[4]} >={args.gap_thres_long} insertions\n")
    return 0


# --------------------------------------------------------------------- view
def view(argv) -> int:
    """BLAST-like / MAF / LASTZ-cigar alignment view (paf_view,
    paftools.js:1365-1530).  Requires the cs tag (cg for lastz-cigar)."""
    ap = argparse.ArgumentParser(prog="paftools view")
    ap.add_argument("-f", dest="fmt", default="aln",
                    choices=("aln", "lastz-cigar", "maf"))
    ap.add_argument("-l", dest="line_len", type=int, default=80)
    ap.add_argument("paf")
    args = ap.parse_args(argv)
    line_len = args.line_len or 0x7FFFFFFF
    out = sys.stdout

    def pad(xv, ln, right):
        s2 = str(xv)
        return s2 + " " * (ln - len(s2)) if right \
            else " " * (ln - len(s2)) + s2

    def update_aln(bufs, elen, op, seq):
        s_ref, s_qry, s_mid = bufs
        ln = 1 if op == "*" else len(seq)
        if op in ":=":
            s_ref.append(seq)
            s_qry.append(seq)
            s_mid.append("|" * ln)
            elen[0] += ln
            elen[1] += ln
        elif op == "*":
            s_ref.append(seq[0])
            s_qry.append(seq[1])
            s_mid.append(" ")
            elen[0] += 1
            elen[1] += 1
        elif op == "+":
            s_ref.append("-" * ln)
            s_qry.append(seq)
            s_mid.append(" " * ln)
            elen[1] += ln
        elif op == "-":
            s_ref.append(seq)
            s_qry.append("-" * ln)
            s_mid.append(" " * ln)
            elen[0] += ln

    def print_aln(rs, qs, strand, slen, elen, bufs):
        s_ref, s_qry, s_mid = ("".join(b) for b in bufs)
        out.write(" ".join(["Ref+:", pad(rs + slen[0] + 1, 10, False),
                            s_ref, pad(rs + elen[0], 10, True)]) + "\n")
        out.write("                 " + s_mid + "\n")
        if strand == "+":
            st2, en2 = qs + slen[1] + 1, qs + elen[1]
        else:
            st2, en2 = qs - slen[1], qs - elen[1] + 1
        out.write(" ".join([f"Qry{strand}:", pad(st2, 10, False),
                            s_qry, pad(en2, 10, True)]) + "\n")

    if args.fmt == "maf":
        out.write("##maf version=1\n\n")
    lineno = 0
    for line in _open(args.paf):
        line = line.rstrip("\n")
        t = line.split("\t", 12)
        lineno += 1
        if args.fmt == "lastz-cigar":
            m = re.search(r"\tcg:Z:(\S+)", line)
            if m is None:
                sys.stderr.write(f"WARNING: no cg tag on line {lineno}\n")
                continue
            ms = re.search(r"\tAS:i:(\d+)", line)
            score = ms.group(1) if ms else 0
            rec = ["cigar:", t[0], t[2], t[3], t[4], t[5], t[7], t[8],
                   "+", score]
            for mm_ in _RE_CIGAR.finditer(m.group(1)):
                rec += [mm_.group(2), mm_.group(1)]
            out.write(" ".join(map(str, rec)) + "\n")
            continue
        m = re.search(r"\tcs:Z:(\S+)", line)
        if m is None:
            sys.stderr.write(f"WARNING: no cs tag on line {lineno}\n")
            continue
        cs = m.group(1)
        if args.fmt == "maf":
            bufs = ([], [], [])
            elen = [0, 0]
            for mm_ in _RE_CS_OP.finditer(cs):
                if mm_.group(1) == ":":
                    raise SystemExit("MAF conversion needs --cs=long")
                update_aln(bufs, elen, mm_.group(1), mm_.group(2))
            ms = re.search(r"\tAS:i:(\d+)", line)
            score = int(ms.group(1)) if ms else 0
            ln = max(len(t[0]), len(t[5]))
            out.write(f"a {score}\n")
            out.write(" ".join(["s", pad(t[5], ln, True),
                                pad(t[7], 10, False),
                                pad(int(t[8]) - int(t[7]), 10, False), "+",
                                pad(t[6], 10, False),
                                "".join(bufs[0])]) + "\n")
            ql = int(t[1])
            if t[4] == "+":
                qs2, qe2 = int(t[2]), int(t[3])
            else:
                qs2, qe2 = ql - int(t[3]), ql - int(t[2])
            out.write(" ".join(["s", pad(t[0], ln, True),
                                pad(qs2, 10, False),
                                pad(qe2 - qs2, 10, False), t[4],
                                pad(ql, 10, False),
                                "".join(bufs[1])]) + "\n\n")
            continue
        # BLAST-like
        n_mm = n_oi = n_od = n_ei = n_ed = 0
        for mm_ in _RE_CS_OP.finditer(cs):
            if mm_.group(1) == "*":
                n_mm += 1
            elif mm_.group(1) == "+":
                n_oi += 1
                n_ei += len(mm_.group(2))
            elif mm_.group(1) == "-":
                n_od += 1
                n_ed += len(mm_.group(2))
        stripped = re.sub(r"\tc[sg]:Z:\S+", "", line)
        out.write(f">{stripped}\tmm:i:{n_mm}\toi:i:{n_oi}\tei:i:{n_ei}"
                  f"\tod:i:{n_od}\ted:i:{n_ed}\n")
        rs = int(t[7])
        qs2 = int(t[2]) if t[4] == "+" else int(t[3])
        bufs = ([], [], [])
        slen = [0, 0]
        elen = [0, 0]
        cur = 0
        n_blocks = 0
        for mm_ in _RE_CS_OP.finditer(cs):
            op, val = mm_.group(1), mm_.group(2)
            if op == ":":
                val = "=" * int(val)
            start, rest = 0, 1 if op == "*" else len(val)
            while rest > 0:
                if cur + rest >= line_len:
                    l_proc = line_len - cur
                    update_aln(bufs, elen, op,
                               val if op == "*" else
                               val[start:start + l_proc])
                    cur += l_proc if op != "*" else 1
                    if n_blocks > 0:
                        out.write("\n")
                    print_aln(rs, qs2, t[4], slen, elen, bufs)
                    n_blocks += 1
                    bufs = ([], [], [])
                    cur = 0
                    slen = [elen[0], elen[1]]
                else:
                    l_proc = rest
                    update_aln(bufs, elen, op,
                               val if op == "*" else
                               val[start:start + l_proc])
                    cur += l_proc
                rest -= l_proc
                start += l_proc
        if cur > 0:
            if n_blocks > 0:
                out.write("\n")
            print_aln(rs, qs2, t[4], slen, elen, bufs)
        out.write("//\n")
    return 0


# ---------------------------------------------------------------------------
# interval helpers (paftools.js:52-120 Interval library semantics)
# ---------------------------------------------------------------------------

def _iv_sort(a):
    a.sort(key=lambda x: (x[0], x[1]))


def _iv_merge(a, sorted_=True):
    if not sorted_:
        _iv_sort(a)
    k = 0
    for i in range(1, len(a)):
        if a[k][1] >= a[i][0]:
            a[k][1] = max(a[k][1], a[i][1])
        else:
            k += 1
            a[k] = list(a[i])
    del a[k + 1:]


def _iv_index_end(a, sorted_=True):
    """Append a start-scan index to each interval (Interval.index_end)."""
    if not a:
        return
    if not sorted_:
        _iv_sort(a)
    a[0].append(0)
    k, k_en = 0, a[0][1]
    for i in range(1, len(a)):
        if k_en <= a[i][0]:
            k += 1
            while k < i:
                if a[k][1] > a[i][0]:
                    break
                k += 1
            k_en = a[k][1]
        a[i].append(k)


def _iv_find_intv(a, x):
    left, right = -1, len(a)
    while right - left > 1:
        mid = left + ((right - left) >> 1)
        if a[mid][0] > x:
            right = mid
        elif a[mid][0] < x:
            left = mid
        else:
            return mid
    return left


def _iv_find_ovlp(a, st, en):
    if not a or st >= en:
        return []
    low = _iv_find_intv(a, st)
    k = 0 if low < 0 else a[low][-1]
    b = []
    for i in range(k, len(a)):
        if a[i][0] >= en:
            break
        if st < a[i][1]:
            b.append(a[i])
    return b


def _fmt2(v: float) -> str:
    """JS Number.toFixed(2) (round-half-away-from-zero)."""
    import math
    if v != v:  # NaN
        return "NaN"
    s = 1 if v >= 0 else -1
    return f"{s * math.floor(abs(v) * 100 + 0.5) / 100:.2f}"


# ---------------------------------------------------------------------------
# junceval (paftools.js:2346-2516)
# ---------------------------------------------------------------------------

def junceval(argv) -> int:
    """Evaluate splice junction consistency with a GTF annotation."""
    ap = argparse.ArgumentParser(prog="paftools junceval")
    ap.add_argument("-l", dest="l_fuzzy", type=int, default=0)
    ap.add_argument("-p", dest="print_ovlp", action="store_true")
    ap.add_argument("-e", dest="print_err_only", action="store_true")
    ap.add_argument("-c", dest="chr_only", action="store_true")
    ap.add_argument("gtf")
    ap.add_argument("aln", nargs="?", default="-")
    args = ap.parse_args(argv)
    print_ovlp = args.print_ovlp or args.print_err_only
    out = sys.stdout

    tr = {}
    with _open(args.gtf) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if t[0].startswith("#") or len(t) < 9 or t[2] != "exon":
                continue
            m = re.search(r'transcript_id "(\S+)"', t[8])
            if m is None:
                continue
            tid = m.group(1)
            tr.setdefault(tid, [t[0], t[6], 0, 0, []])[4].append(
                [int(t[3]) - 1, int(t[4])])
    anno = {}
    for tid, t in tr.items():
        s = t[4]
        _iv_sort(s)
        for i in range(len(s) - 1):
            if s[i][1] >= s[i + 1][0]:
                sys.stderr.write(f"WARNING: incorrect annotation for "
                                 f"transcript {tid} ({s[i][1]} >= "
                                 f"{s[i+1][0]})\n")
            # NB: the reference's warn() swallows the push into its
            # statement only syntactically; the push always runs
            anno.setdefault(t[0], []).append([s[i][1], s[i + 1][0]])
    for chrom, e in anno.items():
        if not e:
            continue
        _iv_sort(e)
        k = 0
        for i in range(1, len(e)):
            if e[i][0] != e[k][0] or e[i][1] != e[k][1]:
                k += 1
                e[k] = list(e[i])
        del e[k + 1:]
        _iv_index_end(e)

    n_pri = n_unmapped = n_mapped = 0
    n_sgl = n_splice = n_splice_hit = n_splice_novel = 0
    last_qname = None
    re_cigar = re.compile(r"(\d+)([MIDNSHP=X])")
    chr_re = re.compile(r"^(chr)?([0-9]+|X|Y)$")
    with _open(args.aln) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if t[0].startswith("@"):
                continue
            qname = t[0]
            if len(t) > 4 and t[4] in ("+", "-", "*"):  # PAF
                ctg, pos, cigar, typ = t[5], int(t[7]), None, "P"
                for fld in t[12:]:
                    m = re.match(r"^(tp:A|cg:Z):(\S+)", fld)
                    if m:
                        if m.group(1) == "tp:A":
                            typ = m.group(2)
                        else:
                            cigar = m.group(2)
                if typ == "S":
                    continue
            else:  # SAM
                ctg, pos, cigar = t[2], int(t[3]) - 1, t[5]
                if int(t[1]) & 0x100:
                    continue
            if args.chr_only and not chr_re.match(ctg):
                continue
            if ctg == "*":
                n_unmapped += 1
                continue
            n_pri += 1
            if last_qname != qname:
                n_mapped += 1
                last_qname = qname
            introns = []
            for m in re_cigar.finditer(cigar or ""):
                ln, op = int(m.group(1)), m.group(2)
                if op == "N":
                    introns.append([pos, pos + ln])
                    pos += ln
                elif op in "MX=D":
                    pos += ln
            if not introns:
                n_sgl += 1
                continue
            n_splice += len(introns)
            chrom = anno.get(ctg)
            if chrom is None:
                n_splice_novel += len(introns)
                continue
            for i, iv in enumerate(introns):
                o = _iv_find_ovlp(chrom, iv[0], iv[1])
                if o:
                    hit = False
                    for oj in o:
                        if (abs(iv[0] - oj[0]) <= args.l_fuzzy
                                and abs(iv[1] - oj[1]) <= args.l_fuzzy):
                            n_splice_hit += 1
                            hit = True
                        if hit:
                            break
                    if print_ovlp:
                        if hit and args.print_err_only:
                            continue
                        typ = "C" if hit else "P"
                        x = "[" + ", ".join(f"({oj[0]},{oj[1]})"
                                            for oj in o) + "]"
                        _p(typ, qname, i + 1, ctg, iv[0], iv[1], x)
                else:
                    n_splice_novel += 1
                    if print_ovlp:
                        _p("N", qname, i + 1, ctg, iv[0], iv[1])
    if not print_ovlp:
        out.write(f"# unmapped reads: {n_unmapped}\n")
        out.write(f"# mapped reads: {n_mapped}\n")
        out.write(f"# primary alignments: {n_pri}\n")
        out.write(f"# singletons: {n_sgl}\n")
        out.write(f"# predicted introns: {n_splice}\n")
        out.write(f"# non-overlapping introns: {n_splice_novel}\n")
        pct = _fmt2(n_splice_hit / n_splice * 100) if n_splice else "NaN"
        out.write(f"# correct introns: {n_splice_hit} ({pct}%)\n")
    return 0


# ---------------------------------------------------------------------------
# bedcov (paftools.js:1141-1261)
# ---------------------------------------------------------------------------

def bedcov(argv) -> int:
    """Number of target.bed bases covered by regions.bed."""
    ap = argparse.ArgumentParser(prog="paftools bedcov")
    ap.add_argument("-p", dest="print_len", action="store_true")
    ap.add_argument("-d", dest="dedup", action="store_true")
    ap.add_argument("-e", dest="excl", default=None)
    ap.add_argument("regions")
    ap.add_argument("target", nargs="?", default="-")
    args = ap.parse_args(argv)
    if args.dedup:
        # the reference calls Interval.dedup, which paftools.js never
        # defines — `bedcov -d` crashes there (paftools.js:1171)
        raise SystemExit("bedcov -d: Interval.dedup is undefined in the "
                         "reference paftools.js; unsupported")

    def read_bed(fn, to_merge):
        h = {}
        with _open(fn) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                lst = h.setdefault(t[0], [])
                bst, ben = int(t[1]), int(t[2])
                if len(t) >= 12 and re.match(r"^\d+$", t[9]):
                    nb = int(t[9])
                    sz = t[10].split(",")
                    st = t[11].split(",")
                    for i in range(nb):
                        s0 = bst + int(st[i])
                        lst.append([s0, s0 + int(sz[i]), 0, 0, 0])
                else:
                    lst.append([bst, ben, 0, 0, 0])
        for chrom in h:
            if to_merge:
                _iv_merge(h[chrom], sorted_=False)
            else:
                _iv_sort(h[chrom])
            _iv_index_end(h[chrom])
        return h

    excl = read_bed(args.excl, True) if args.excl else None
    target = read_bed(args.regions, True)
    out = sys.stdout
    tot_len = hit_len = 0
    with _open(args.target) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            a = []
            bst, ben = int(t[1]), int(t[2])
            if len(t) >= 12 and re.match(r"^\d+$", t[9]):
                nb = int(t[9])
                sz = t[10].split(",")
                st = t[11].split(",")
                for i in range(nb):
                    s0 = bst + int(st[i])
                    a.append([s0, s0 + int(sz[i]), False])
            else:
                a.append([bst, ben, False])
            feat_len = 0
            for iv in a:
                if excl is not None and t[0] in excl:
                    if _iv_find_ovlp(excl[t[0]], iv[0], iv[1]):
                        continue
                iv[2] = True
                feat_len += iv[1] - iv[0]
            tot_len += feat_len
            if t[0] not in target:
                continue
            b = []
            for iv in a:
                if not iv[2]:
                    continue
                for oj in _iv_find_ovlp(target[t[0]], iv[0], iv[1]):
                    mst = max(oj[0], iv[0])
                    men = min(oj[1], iv[1])
                    b.append([mst, men])
                    oj[2] += men - mst
                    oj[3] += 1
                    if mst == oj[0] and men == oj[1]:
                        oj[4] += 1
            feat_hit_len = 0
            if b:
                b.sort(key=lambda x: x[0])
                st0, en0 = b[0]
                for iv in b[1:]:
                    if iv[0] <= en0:
                        en0 = max(en0, iv[1])
                    else:
                        feat_hit_len += en0 - st0
                        st0, en0 = iv
                feat_hit_len += en0 - st0
            hit_len += feat_hit_len
            if args.print_len:
                _p("F", "\t".join(t[:4]), feat_len, feat_hit_len)
    sys.stderr.write(f"# target bases: {tot_len}\n")
    pct = _fmt2(100.0 * hit_len / tot_len) if tot_len else "NaN"
    sys.stderr.write(f"# target bases overlapping regions: {hit_len} "
                     f"({pct}%)\n")
    return 0


# ---------------------------------------------------------------------------
# vcfstat (paftools.js:2588-2651)
# ---------------------------------------------------------------------------

def vcfstat(argv) -> int:
    """VCF statistics."""
    ap = argparse.ArgumentParser(prog="paftools vcfstat")
    ap.add_argument("vcf", nargs="?", default="-")
    args = ap.parse_args(argv)
    ts = {"AG", "GA", "CT", "TC"}
    x = dict(sub=0, ts=0, tv=0, ins=0, dele=0, ins1=0, del1=0, ins2=0,
             del2=0, ins50=0, del50=0, ins1k=0, del1k=0, ins7k=0,
             del7k=0, insinf=0, delinf=0)
    with _open(args.vcf) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if t[0].startswith("#"):
                continue
            ref = t[3]
            for a in t[4].split(","):
                # NB: the reference tests a[0]=='<' || a[1]=='>' —
                # replicated verbatim (paftools.js:2600)
                if a[:1] == "<" or a[1:2] == ">":
                    continue
                for cr, ca in zip(ref, a):
                    if cr != ca:
                        x["sub"] += 1
                        if cr + ca in ts:
                            x["ts"] += 1
                        else:
                            x["tv"] += 1
                d = len(a) - len(ref)
                if d > 0:
                    x["ins"] += 1
                    key = ("ins1" if d == 1 else "ins2" if d == 2 else
                           "ins50" if d < 50 else "ins1k" if d < 1000
                           else "ins7k" if d < 7000 else "insinf")
                    x[key] += 1
                elif d < 0:
                    d = -d
                    x["dele"] += 1
                    key = ("del1" if d == 1 else "del2" if d == 2 else
                           "del50" if d < 50 else "del1k" if d < 1000
                           else "del7k" if d < 7000 else "delinf")
                    x[key] += 1
    o = sys.stdout
    import math
    if x["tv"]:
        ratio = x["ts"] / x["tv"]
    elif x["ts"]:
        ratio = math.inf  # JS (n/0).toFixed(3) -> "Infinity"
    else:
        ratio = math.nan
    r3 = ("NaN" if ratio != ratio else "Infinity" if math.isinf(ratio)
          else f"{math.floor(ratio * 1000 + 0.5) / 1000:.3f}")
    o.write(f"# substitutions: {x['sub']}\n")
    o.write(f"ts/tv: {r3}\n")
    o.write(f"# insertions: {x['ins']}\n")
    o.write(f"# 1bp insertions: {x['ins1']}\n")
    o.write(f"# 2bp insertions: {x['ins2']}\n")
    o.write(f"# [3,50) insertions: {x['ins50']}\n")
    o.write(f"# [50,1000) insertions: {x['ins1k']}\n")
    o.write(f"# [1000,7000) insertions: {x['ins7k']}\n")
    o.write(f"# >=7000 insertions: {x['insinf']}\n")
    o.write(f"# deletions: {x['dele']}\n")
    o.write(f"# 1bp deletions: {x['del1']}\n")
    o.write(f"# 2bp deletions: {x['del2']}\n")
    o.write(f"# [3,50) deletions: {x['del50']}\n")
    o.write(f"# [50,1000) deletions: {x['del1k']}\n")
    o.write(f"# [1000,7000) deletions: {x['del7k']}\n")
    o.write(f"# >=7000 deletions: {x['delinf']}\n")
    return 0


# ---------------------------------------------------------------------------
# pafcmp (paftools.js:2999-3115)
# ---------------------------------------------------------------------------

def pafcmp(argv) -> int:
    """Compare two PAF files (base vs test)."""
    ap = argparse.ArgumentParser(prog="paftools pafcmp")
    ap.add_argument("-q", dest="min_mapq", type=int, default=10)
    ap.add_argument("base")
    ap.add_argument("test")
    args = ap.parse_args(argv)
    min_len, min_ovlp = 5000, 0.5
    ev = dict(n_base=0, n_test=0, n_out_high=0, n_out_low=0, n_hit=0,
              n_wrong=0, n_miss=0)
    out = sys.stdout

    base: dict = {}

    def groups(fn):
        a = []
        with _open(fn) as f:
            for line in f:
                if "\ttp:A:S" in line:
                    continue
                t = line.rstrip("\n").split("\t")
                if a and a[0][0] != t[0]:
                    yield a
                    a = []
                a.append(t)
        if a:
            yield a

    sys.stderr.write(f"Reading {args.base}...\n")
    for a in groups(args.base):
        if len(a) != 1:
            continue
        r = a[0]
        if int(r[1]) < min_len:
            continue
        if int(r[11]) >= args.min_mapq:
            ev["n_base"] += 1
        base[r[0]] = [r[5], int(r[7]), int(r[8]), int(r[11]), 0, 0]

    sys.stderr.write(f"Reading {args.test}...\n")
    for a in groups(args.test):
        r = a[0]
        if int(r[1]) < min_len:
            continue
        if int(r[11]) >= args.min_mapq:
            ev["n_test"] += 1
        c = [r[5], int(r[7]), int(r[8]), int(r[11])]
        b = base.get(r[0])
        if b is None:
            # the reference increments opt.n_out_high/low here — dead
            # counters (paftools.js:3053-3054); ev.n_out_high stays 0
            continue
        inter, union = 0, (b[2] - b[1]) + (c[2] - c[1])
        if b[0] == c[0]:
            if b[1] < c[1]:
                if b[2] > c[1]:
                    inter, union = b[2] - c[1], c[2] - b[1]
            else:
                if c[2] > b[1]:
                    inter, union = c[2] - b[1], b[2] - c[1]
        if inter >= union * min_ovlp:
            if b[3] >= args.min_mapq:
                ev["n_hit"] += 1
            b[4] += 1
        else:
            if b[3] >= args.min_mapq:
                _p("W", r[0], "\t".join(map(str, b[:4])),
                   "\t".join(map(str, c)))
                ev["n_wrong"] += 1
            b[5] += 1

    for rname, b in base.items():
        if b[3] >= args.min_mapq and b[4] == 0 and b[5] == 0:
            ev["n_miss"] += 1
            _p("M", rname, "\t".join(map(str, b[:4])))
    _p("X", f"{ev['n_base']} base alignments with mapQ>={args.min_mapq}")
    _p("X", f"{ev['n_hit']} base alignments correctly mapped by test")
    _p("X", f"{ev['n_wrong']} wrong test alignment")
    _p("X", f"{ev['n_miss']} base alignments missing")
    _p("X", f"{ev['n_out_high']} additional test alignments with "
       f"mapQ>={args.min_mapq}")
    return 0


# ---------------------------------------------------------------------------
# misjoin (paftools.js:2664-2804)
# ---------------------------------------------------------------------------

def _parse_num(s: str) -> int:
    m = re.match(r"^(\d*\.?\d*)([mMgGkK]?)", s)
    x = float(m.group(1))
    mult = {"k": 1e3, "K": 1e3, "m": 1e6, "M": 1e6,
            "g": 1e9, "G": 1e9}.get(m.group(2), 1)
    import math
    return math.floor(x * mult + 0.499)


def misjoin(argv) -> int:
    """Evaluate large-scale misjoins in an assembly-to-reference PAF."""
    ap = argparse.ArgumentParser(prog="paftools misjoin")
    ap.add_argument("-l", dest="min_seg_len", type=_parse_num,
                    default=1000000)
    ap.add_argument("-g", dest="max_gap", type=_parse_num, default=1000000)
    ap.add_argument("-c", dest="cen_bed", default=None)
    ap.add_argument("-r", dest="cen_ratio", type=float, default=0.5)
    ap.add_argument("-p", dest="show_long", action="store_true")
    ap.add_argument("-e", dest="show_err", action="store_true")
    ap.add_argument("paf", nargs="?", default="-")
    args = ap.parse_args(argv)
    out = sys.stdout
    n_diff, n_gap = [0, 0], [0, 0]
    n_inv, n_inv_end = [0, 0], [0, 0]
    cen: dict = {}
    if args.cen_bed:
        with _open(args.cen_bed) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                cen.setdefault(t[0], []).append([int(t[1]), int(t[2])])

    def test_cen(chrom, st, en):
        b = cen.get(chrom)
        if b is None:
            return False
        ln = 0
        for bj in b:
            if bj[0] < en and bj[1] > st:
                ln += min(bj[1], en) - max(bj[0], st)
        return ln >= (en - st) * args.cen_ratio

    def test_cen_point(chrom, x):
        b = cen.get(chrom)
        if b is None:
            return False
        # the reference leaks this debug line whenever the chromosome
        # has centromere intervals (paftools.js:2715) — replicated
        _p(x, b[0][0], b[0][1])
        for bj in b:
            if bj[0] <= x < bj[1]:
                return True
        return False

    if args.show_err or args.show_long:
        out.write("C\tJ  inter-chromosomal misjoin\n")
        out.write("C\tj  inter-chromosomal misjoin with both breakpoints "
                  "ending in centromeres\n")
        out.write("C\tG  long gap on the reference genome\n")
        out.write("C\tg  long gap on the reference genome with both "
                  "breakpoints ending in centromeres\n")
        out.write("C\tM  closed inversion\n")
        out.write("C\n")

    def process(a):
        rows = []
        for t in a:
            for j in range(1, 4):
                t[j] = int(t[j])
            for j in range(6, 12):
                t[j] = int(t[j])
            if t[10] >= args.min_seg_len:
                rows.append(t)
        if len(rows) <= 1:
            return
        rows.sort(key=lambda x: x[2])
        if args.show_long:
            for t in rows:
                out.write("\t".join(map(str, t)) + "\n")
        i = 1
        while i < len(rows):
            pv, cu = rows[i - 1], rows[i]
            ov = [test_cen(pv[5], pv[7], pv[8]),
                  test_cen(cu[5], cu[7], cu[8])]
            end_cen = [test_cen_point(pv[5],
                                      pv[8] if pv[4] == "+" else pv[7]),
                       test_cen_point(cu[5],
                                      cu[7] if cu[4] == "+" else cu[8])]
            if pv[5] != cu[5]:
                if ov[0] or ov[1]:
                    n_diff[1] += 1
                elif args.show_err:
                    lbl = "j" if end_cen[0] and end_cen[1] else "J"
                    _p(lbl, "\t".join(map(str, pv[:12])))
                    _p(lbl, "\t".join(map(str, cu[:12])))
                n_diff[0] += 1
            elif pv[4] == cu[4]:
                dq = cu[2] - pv[3]
                dr = cu[7] - pv[8] if cu[4] == "+" else pv[7] - cu[8]
                gap = abs(dr - dq)
                if gap > args.max_gap:
                    if ov[0] or ov[1]:
                        n_gap[1] += 1
                    elif args.show_err:
                        lbl = "g" if end_cen[0] and end_cen[1] else "G"
                        _p(lbl, "\t".join(map(str, pv[:12])))
                        _p(lbl, "\t".join(map(str, cu[:12])))
                    n_gap[0] += 1
            elif i + 1 < len(rows) and rows[i + 1][4] == pv[4]:
                if ov[0] or ov[1]:
                    n_inv[1] += 1
                elif args.show_err:
                    for t in (pv, cu, rows[i + 1]):
                        _p("M", "\t".join(map(str, t[:12])))
                n_inv[0] += 1
                i += 1
            else:
                if ov[0] or ov[1]:
                    n_inv_end[1] += 1
                n_inv_end[0] += 1
            i += 1

    a = []
    with _open(args.paf) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if a and a[0][0] != t[0]:
                process(a)
                a = []
            a.append(t)
    if a:
        process(a)
    out.write(f"# inter-chromosomal misjoins: {n_diff[0]},{n_diff[1]}\n")
    out.write(f"# intra-chromosomal gaps: {n_gap[0]},{n_gap[1]}\n")
    out.write(f"# candidate inversions in the middle: "
              f"{n_inv[0]},{n_inv[1]}\n")
    out.write(f"# candidate inversions at contig ends: "
              f"{n_inv_end[0]},{n_inv_end[1]}\n")
    return 0


# ---------------------------------------------------------------------------
# ov-eval (paftools.js:2517-2586)
# ---------------------------------------------------------------------------

def ov_eval(argv) -> int:
    """Read-overlap sensitivity from read-to-ref mapping."""
    ap = argparse.ArgumentParser(prog="paftools ov-eval")
    ap.add_argument("-l", dest="min_ovlp", type=int, default=2000)
    ap.add_argument("-q", dest="min_mapq", type=int, default=10)
    ap.add_argument("-f", dest="min_frac", type=float, default=0.95)
    ap.add_argument("to_ref_paf")
    ap.add_argument("ovlp_paf")
    args = ap.parse_args(argv)
    a: list = []
    h: dict = {}
    with _open(args.to_ref_paf) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if int(t[11]) < args.min_mapq:
                continue
            if not any(fld == "tp:A:P" for fld in t[12:]):
                continue
            ql, qs, qe = int(t[1]), int(t[2]), int(t[3])
            ts_, te_ = int(t[7]), int(t[8])
            if (qe - qs < args.min_ovlp or te_ - ts_ < args.min_ovlp
                    or (qe - qs) / ql < args.min_frac):
                continue
            ctg, st, en = t[5], ts_, te_
            while a:
                if a[0][0] == ctg and a[0][2] > st:
                    break
                a.pop(0)
            for aj in a:
                if aj[3] == t[0]:
                    continue
                ln = min(en, aj[2]) - st
                if ln >= args.min_ovlp:
                    key = (aj[3] + "\t" + t[0] if aj[3] < t[0]
                           else t[0] + "\t" + aj[3])
                    h[key] = ln
            a.append([ctg, st, en, t[0]])
    with _open(args.ovlp_paf) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            key = (t[0] + "\t" + t[5] if t[0] < t[5]
                   else t[5] + "\t" + t[0])
            if h.get(key, 0) > 0:
                h[key] = -h[key]
    n_ovlp = len(h)
    n_missing = sum(1 for v in h.values() if v > 0)
    out = sys.stdout
    out.write(f"{n_ovlp} overlaps inferred from the reference mapping\n")
    out.write(f"{n_missing} missed by the read overlapper\n")
    pct = _fmt2(100 * (1 - n_missing / n_ovlp)) if n_ovlp else "NaN"
    out.write(f"{pct}% sensitivity\n")
    return 0


def version(argv) -> int:
    """Reference paftools.js version string (paftools.js:3)."""
    sys.stdout.write("2.24-r1132-dirty\n")
    return 0


# ---------------------------------------------------------------------------
# gff2bed (paftools.js:1533-1693)
# ---------------------------------------------------------------------------

_GFF_COLORS = {"protein_coding": "0,128,255", "mRNA": "0,128,255",
               "lincRNA": "0,192,0", "snRNA": "0,192,0",
               "miRNA": "0,192,0", "misc_RNA": "0,192,0"}


def gff2bed(argv) -> int:
    """Convert GTF/GFF3 to BED12 (or junction BED with -j)."""
    ap = argparse.ArgumentParser(prog="paftools gff2bed")
    ap.add_argument("-u", dest="ucsc_fai", default=None)
    ap.add_argument("-s", dest="short", action="store_true")
    ap.add_argument("-g", dest="keep_gff", action="store_true")
    ap.add_argument("-j", dest="junc", action="store_true")
    ap.add_argument("-G", dest="gene", action="store_true")
    ap.add_argument("-e", dest="canon", action="store_true")
    ap.add_argument("gff")
    args = ap.parse_args(argv)

    ens2ucsc = {}
    if args.ucsc_fai:
        with _open(args.ucsc_fai) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                s = t[0]
                if re.search(r"_(random|alt|decoy)$", s):
                    s = re.sub(r"_(random|alt|decoy)$", "", s)
                    s = re.sub(r"^chr\S+_", "", s)
                else:
                    s = re.sub(r"^chrUn_", "", s)
                s = re.sub(r"v(\d+)", r".\1", s, count=1)
                if s != t[0]:
                    ens2ucsc[s] = t[0]

    def print_bed12(exons, cds_st, cds_en):
        if not exons:
            return
        name = (exons[0][7] + "|" + exons[0][5] if args.short
                else "|".join(str(v) for v in exons[0][4:7]))
        a = sorted(exons, key=lambda e: e[1])
        if args.junc:
            for i in range(1, len(a)):
                _p(a[i][0], a[i - 1][2], a[i][1], name, 1000, a[i][3])
            return
        st, en = a[0][1], a[-1][2]
        if cds_st == 1 << 30:
            cds_st = st
        if cds_en == 0:
            cds_en = en
        if cds_st < st or cds_en > en:
            raise SystemExit("inconsistent thick start or end for "
                             f"transcript {a[0][4]}")
        sizes = ",".join(str(e[2] - e[1]) for e in a) + ","
        starts = ",".join(str(e[1] - st) for e in a) + ","
        color = _GFF_COLORS.get(a[0][5], "196,196,196")
        _p(a[0][0], st, en, name, 1000, a[0][3], cds_st, cds_en, color,
           len(a), sizes, starts)

    re_gtf = re.compile(r'\b(transcript_id|transcript_type|'
                        r'transcript_biotype|gene_name|gene_id|gbkey|'
                        r'transcript_name|tag) "([^"]+)";')
    re_gff3 = re.compile(r"\b(transcript_id|transcript_type|"
                         r"transcript_biotype|gene_name|gene_id|gbkey|"
                         r"transcript_name)=([^;]+)")
    re_gtf_gene = re.compile(r'\b(gene_id|gene_type|gene_name) "([^;]+)";')
    re_gff3_gene = re.compile(r"\b(gene_id|gene_type|source_gene|"
                              r"gene_biotype|gene_name)=([^;]+);")

    exons: list = []
    cds_st, cds_en = 1 << 30, 0
    last_id = None
    with _open(args.gff) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if args.keep_gff:
                if not t[0].startswith("#") and t[0] in ens2ucsc:
                    t[0] = ens2ucsc[t[0]]
                sys.stdout.write("\t".join(t) + "\n")
                continue
            if t[0].startswith("#") or len(t) < 9:
                continue
            if args.gene:
                if t[2] != "gene":
                    continue
                gid = src = biotype = None
                gtype, gname = "", "N/A"
                for m in re_gtf_gene.finditer(t[8]):
                    if m.group(1) == "gene_id":
                        gid = m.group(2)
                    elif m.group(1) == "gene_type":
                        gtype = m.group(2)
                    elif m.group(1) == "gene_name":
                        gname = m.group(2)
                for m in re_gff3_gene.finditer(t[8]):
                    if m.group(1) == "gene_id":
                        gid = m.group(2)
                    elif m.group(1) == "source_gene":
                        src = m.group(2)
                    elif m.group(1) == "gene_type":
                        gtype = m.group(2)
                    elif m.group(1) == "gene_biotype":
                        biotype = m.group(2)
                    elif m.group(1) == "gene_name":
                        gname = m.group(2)
                if src is not None:
                    gid = src
                if gtype == "" and biotype is not None:
                    gtype = biotype
                _p(t[0], int(t[3]) - 1, t[4],
                   "|".join(str(v) for v in (gid, gtype, gname)), 1000,
                   t[6])
                continue
            if t[2] not in ("CDS", "exon"):
                continue
            st3, en4 = int(t[3]) - 1, int(t[4])
            tid, ttype, gname, biotype, tname = None, "", "N/A", "", "N/A"
            canonical = False
            for m in re_gtf.finditer(t[8]):
                k, v = m.group(1), m.group(2)
                if k == "transcript_id":
                    tid = v
                elif k == "transcript_type":
                    ttype = v
                elif k in ("transcript_biotype", "gbkey"):
                    biotype = v
                elif k in ("gene_name", "gene_id"):
                    gname = v
                elif k == "transcript_name":
                    tname = v
                elif k == "tag" and v == "Ensembl_canonical":
                    canonical = True
            for m in re_gff3.finditer(t[8]):
                k, v = m.group(1), m.group(2)
                if k == "transcript_id":
                    tid = v
                elif k == "transcript_type":
                    ttype = v
                elif k in ("transcript_biotype", "gbkey"):
                    biotype = v
                elif k in ("gene_name", "gene_id"):
                    gname = v
                elif k == "transcript_name":
                    tname = v
            if args.canon and not canonical:
                continue
            if ttype == "" and biotype != "":
                ttype = biotype
            if tid is None:
                raise SystemExit("No transcript_id")
            if tid != last_id:
                print_bed12(exons, cds_st, cds_en)
                exons, cds_st, cds_en = [], 1 << 30, 0
                last_id = tid
            if t[2] == "CDS":
                cds_st = min(cds_st, st3)
                cds_en = max(cds_en, en4)
            else:
                chrom = t[0]
                if args.ucsc_fai:
                    if chrom in ens2ucsc:
                        chrom = ens2ucsc[chrom]
                    elif re.match(r"^[A-Z]+\d+\.\d+$", chrom):
                        chrom = re.sub(r"([A-Z]+\d+)\.(\d+)",
                                       r"chrUn_\1v\2", chrom)
                exons.append([chrom, st3, en4, t[6], tid, ttype, gname,
                              tname])
    if last_id is not None:
        print_bed12(exons, cds_st, cds_en)
    return 0


# ---------------------------------------------------------------------------
# splice2bed (paftools.js:1920-2035)
# ---------------------------------------------------------------------------

def splice2bed(argv) -> int:
    """Convert spliced PAF/SAM alignments to BED12."""
    ap = argparse.ArgumentParser(prog="paftools splice2bed")
    ap.add_argument("-f", dest="fmt", default="bed")
    ap.add_argument("-n", dest="name_conv", default=None)
    ap.add_argument("-m", dest="keep_multi", action="store_true")
    ap.add_argument("input")
    args = ap.parse_args(argv)
    colors = ["0,128,255", "255,0,0", "0,192,0"]

    conv = None
    if args.name_conv:
        conv = {}
        with _open(args.name_conv) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                conv[t[0]] = t[1]

    def print_lines(a):
        if not a:
            return
        if args.fmt == "bed":
            n_pri = sum(1 for r in a if r[8] == 0)
            if n_pri > 1:
                for r in a:
                    if r[8] == 0:
                        r[8] = 1
            elif n_pri == 0:
                sys.stderr.write(f"Warning: {a[0][3]} doesn't have a "
                                 "primary alignment\n")
            for r in a:
                if not args.keep_multi and r[8] == 2:
                    continue
                r[8] = colors[r[8]]
                sys.stdout.write("\t".join(map(str, r)) + "\n")

    re_cig = re.compile(r"(\d+)([MIDNSHP=X])")
    a: list = []
    with _open(args.input) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("@"):
                continue
            t = line.split("\t")
            is_pri, cigar = False, None
            if conv is not None and t[0] in conv:
                t[0] = conv[t[0]]
            if (len(t) >= 10 and t[4] not in ("+", "-")
                    and re.match(r"^\d+", t[1])):  # SAM
                flag = int(t[1])
                if flag & 1:
                    t[0] += "/" + str(flag >> 6 & 3)
            if a and a[0][3] != t[0]:
                print_lines(a)
                a = []
            if len(t) >= 12 and t[4] in ("+", "-"):  # PAF
                for fld in t[12:]:
                    if fld.startswith("cg:Z:"):
                        cigar = fld[5:]
                    elif fld.startswith("s2:i:"):
                        is_pri = True
                a1 = [t[5], int(t[7]), int(t[8]), t[0],
                      int(int(t[9]) / int(t[10]) * 1000), t[4]]
            elif len(t) >= 10:  # SAM
                flag = int(t[1])
                if (flag & 4) or t[2] == "*":
                    continue
                cigar = t[5]
                is_pri = not (flag & 0x100)
                a1 = [t[2], int(t[3]) - 1, None, t[0], 1000,
                      "-" if flag & 16 else "+"]
            else:
                raise SystemExit("unrecognized input format")
            if cigar is None:
                raise SystemExit("missing CIGAR")
            x0 = x = 0
            bs, bl = [], []
            for m in re_cig.finditer(cigar):
                ln, op = int(m.group(1)), m.group(2)
                if op in "MD":
                    x += ln
                elif op == "N":
                    bs.append(x0)
                    bl.append(x - x0)
                    x += ln
                    x0 = x
            bs.append(x0)
            bl.append(x - x0)
            if a1[2] is None:
                a1[2] = a1[1] + x
            a1 += [a1[1], a1[2], 0 if is_pri else 2, len(bs),
                   ",".join(map(str, bl)) + ",",
                   ",".join(map(str, bs)) + ","]
            a.append(a1)
    print_lines(a)
    return 0


# ---------------------------------------------------------------------------
# delta2paf (paftools.js:1857-1918)
# ---------------------------------------------------------------------------

def delta2paf(argv) -> int:
    """Convert MUMmer delta to PAF."""
    ap = argparse.ArgumentParser(prog="paftools delta2paf")
    ap.add_argument("delta")
    args = ap.parse_args(argv)
    rname = qname = None
    rlen = qlen = 0
    seen_gt = False
    strand = rs = re_ = qs = qe = x = y = nm = 0
    cigar: list = []
    with _open(args.delta) as f:
        for line in f:
            line = line.rstrip("\n")
            m = re.match(r"^>(\S+)\s+(\S+)\s+(\d+)\s+(\d+)", line)
            if m:
                rname, qname = m.group(1), m.group(2)
                rlen, qlen = int(m.group(3)), int(m.group(4))
                seen_gt = True
                continue
            if not seen_gt:
                continue
            t = line.split(" ")
            if len(t) == 7:
                ti = [int(v) for v in t[:5]]
                strand = (1 if (ti[0] < ti[1]) == (ti[2] < ti[3]) else -1)
                rs, re_ = min(ti[0], ti[1]) - 1, max(ti[0], ti[1])
                qs, qe = min(ti[2], ti[3]) - 1, max(ti[2], ti[3])
                x = y = 0
                nm = ti[4]
                cigar = []
            elif len(t) == 1:
                d = int(t[0])
                if d == 0:
                    if re_ - rs - x != qe - qs - y:
                        raise SystemExit("inconsisnt alignment")
                    cigar.append((re_ - rs - x) << 4)
                    blen = 0
                    cs = []
                    for c in cigar:
                        blen += c >> 4
                        cs.append(str(c >> 4) + "MID"[c & 0xF])
                    _p("\t".join(map(str, [
                        qname, qlen, qs, qe, "+" if strand > 0 else "-",
                        rname, rlen, rs, re_, blen - nm, blen, 0,
                        f"NM:i:{nm}", "cg:Z:" + "".join(cs)])))
                elif d > 0:
                    ln = d - 1
                    x += ln + 1
                    y += ln
                    if ln > 0:
                        cigar.append(ln << 4)
                    if cigar and (cigar[-1] & 0xF) == 2:
                        cigar[-1] += 1 << 4
                    else:
                        cigar.append(1 << 4 | 2)
                else:
                    ln = -d - 1
                    x += ln
                    y += ln + 1
                    if ln > 0:
                        cigar.append(ln << 4)
                    if cigar and (cigar[-1] & 0xF) == 1:
                        cigar[-1] += 1 << 4
                    else:
                        cigar.append(1 << 4 | 1)
    return 0


# ---------------------------------------------------------------------------
# mason2fq / pbsim2fq (paftools.js:2209-2344)
# ---------------------------------------------------------------------------

_COMP = str.maketrans("ACGTUacgtuRYSWKMBDHVryswkmbdhv",
                      "TGCAAtgcaaYRSWMKVHDByrswmkvhdb")


def mason2fq(argv) -> int:
    """Convert mason2-simulated SAM to FASTQ with truth names."""
    ap = argparse.ArgumentParser(prog="paftools mason2fq")
    ap.add_argument("sam")
    args = ap.parse_args(argv)
    o = sys.stdout

    def print_se(a):
        o.write("@" + "!".join(map(str, a[:5])) + " " + a[8] + "\n")
        o.write(a[5] + "\n+\n" + a[6] + "\n")

    re_cig = re.compile(r"(\d+)([MIDSHN])")
    last = None
    with _open(args.sam) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if t[0].startswith("@"):
                continue
            l_ref = sum(int(m.group(1))
                        for m in re_cig.finditer(t[5])
                        if m.group(2) in "DMN")
            flag = int(t[1])
            if flag & 16:
                seq = t[9].translate(_COMP)[::-1]
                qual = t[10][::-1]
            else:
                seq, qual = t[9], t[10]
            qname = re.sub(r"^simulated.", "", t[0], count=1)
            chrom = t[2]
            pos = int(t[3]) - 1
            strand = "-" if flag & 16 else "+"
            read_no = flag & 0xC0
            read_no = 1 if read_no == 0x40 else 2 if read_no == 0x80 else 0
            err = snp = indel = 0
            for fld in t[11:]:
                m = re.match(r"^XE:i:(\d+)", fld)
                if m:
                    err = m.group(1)
                    continue
                m = re.match(r"^XS:i:(\d+)", fld)
                if m:
                    snp = m.group(1)
                    continue
                m = re.match(r"^XI:i:(\d+)", fld)
                if m:
                    indel = m.group(1)
            comment = f"{err}:{snp}:{indel}"
            cur = [qname, chrom, pos, pos + l_ref, strand, seq, qual,
                   read_no, comment]
            if last is None:
                last = cur
            elif last[0] != qname:
                print_se(last)
                last = cur
            else:
                if read_no == 2:
                    if last[7] != 1:
                        raise SystemExit("ERROR: can't find read1")
                    name = "!".join(map(str, [
                        qname, chrom, f"{last[2]}_{pos}",
                        f"{last[3]}_{pos + l_ref}", last[4] + strand]))
                    o.write(f"@{name}/1 {last[8]}\n{last[5]}\n+\n"
                            f"{last[6]}\n")
                    o.write(f"@{name}/2 {comment}\n{seq}\n+\n{qual}\n")
                else:
                    if last[7] != 2:
                        raise SystemExit("ERROR: can't find read2")
                    name = "!".join(map(str, [
                        qname, chrom, f"{pos}_{last[2]}",
                        f"{pos + l_ref}_{last[3]}", strand + last[4]]))
                    o.write(f"@{name}/1 {comment}\n{seq}\n+\n{qual}\n")
                    o.write(f"@{name}/2 {last[8]}\n{last[5]}\n+\n"
                            f"{last[6]}\n")
                last = None
    if last is not None:
        print_se(last)
    return 0


def pbsim2fq(argv) -> int:
    """Convert PBSIM MAF(s) to FASTA with truth names."""
    ap = argparse.ArgumentParser(prog="paftools pbsim2fq")
    ap.add_argument("fai")
    ap.add_argument("mafs", nargs="+")
    args = ap.parse_args(argv)
    o = sys.stdout
    chr_list = []
    with _open(args.fai) as f:
        for line in f:
            chr_list.append(line.split()[0])
    for fn in args.mafs:
        state = 0
        reg = None
        with _open(fn) as f:
            for line in f:
                line = line.rstrip("\n")
                if state == 0 and line.startswith("a"):
                    state = 1
                elif state == 1 and line.startswith("s"):
                    t = re.split(r"\s+", line)
                    st = int(t[2])
                    reg = [st, st + int(t[3])]
                    state = 2
                elif state == 2 and line.startswith("s"):
                    t = re.split(r"\s+", line)
                    m = re.search(r"S(\d+)_\d+", t[1])
                    if m is None:
                        raise SystemExit("Failed to parse the read name")
                    chr_id = int(m.group(1)) - 1
                    if chr_id >= len(chr_list):
                        raise SystemExit("Index outside the chr list")
                    name = "!".join(map(str, [t[1], chr_list[chr_id],
                                              reg[0], reg[1], t[4]]))
                    seq = t[6].replace("-", "")
                    if len(seq) != int(t[5]):
                        raise SystemExit("Inconsistent read length")
                    if "NN" not in seq:
                        if t[4] == "-":
                            seq = seq.translate(_COMP)[::-1]
                        o.write(">" + name + "\n" + seq + "\n")
                    state = 0
    return 0


# ---------------------------------------------------------------------------
# vcfpair (paftools.js:1262-1363)
# ---------------------------------------------------------------------------

def vcfpair(argv) -> int:
    """Merge a 2-sample haploid pair VCF into one diploid sample."""
    ap = argparse.ArgumentParser(prog="paftools vcfpair")
    ap.add_argument("-m", dest="male", action="store_true")
    ap.add_argument("-s", dest="sample", default="syndip")
    ap.add_argument("-g", dest="hgver", default=None)
    ap.add_argument("vcf", nargs="?", default="-")
    args = ap.parse_args(argv)
    PAR = {"37": [[0, 2699520], [154931043, 155260560]]}
    if args.male and (args.hgver is None or args.hgver not in PAR):
        raise SystemExit("for a male, -g must be specified to properly "
                         "handle PARs on chrX")
    re_ctg = (re.compile(r"^(chr)?([0-9]+|X|Y)$") if args.male
              else re.compile(r"^(chr)?([0-9]+|X)$"))
    o = sys.stdout
    with _open(args.vcf) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("#"):
                if re.match(r"^##(source|reference)=", line):
                    continue
                m = re.match(r"^##contig=.*ID=([^\s,]+)", line)
                if m:
                    if not re_ctg.match(m.group(1)):
                        continue
                elif line.startswith("#CHROM"):
                    t = line.split("\t")
                    t = t[:-1]
                    t[-1] = args.sample
                    line = "\t".join(t)
                    o.write('##FILTER=<ID=HET1,Description="Heterozygous '
                            'in the first haplotype">\n')
                    o.write('##FILTER=<ID=HET2,Description="Heterozygous '
                            'in the second haplotype">\n')
                    o.write('##FILTER=<ID=GAP1,Description="Uncalled in '
                            'the first haplotype">\n')
                    o.write('##FILTER=<ID=GAP2,Description="Uncalled in '
                            'the second haplotype">\n')
                o.write(line + "\n")
                continue
            t = line.split("\t")
            if not re_ctg.match(t[0]):
                continue
            AD = None
            FILTER = []
            HT = [None, None]
            ok = True
            for i in range(2):
                m = re.match(r"^(\.|[0-9]+)/(\.|[0-9]+):(\S+)", t[9 + i])
                if m is None:
                    sys.stderr.write(line + "\n")
                    raise SystemExit("malformatted VCF")
                s = m.group(3).split(",")
                if AD is None:
                    AD = [0] * len(s)
                for j, v in enumerate(s):
                    AD[j] += int(v)
                if m.group(1) == ".":
                    FILTER.append("GAP" + "12"[i])
                    HT[i] = "."
                elif m.group(1) != m.group(2):
                    FILTER.append("HET" + "12"[i])
                    HT[i] = "."
                else:
                    HT[i] = m.group(1)
            del ok
            t = t[:-1]
            hap = 0
            st = int(t[1])
            en = st + len(t[3])
            if args.male:
                if re.match(r"^(chr)?X", t[0]):
                    r = PAR[args.hgver]
                    in_par = any(ri[0] <= st and en <= ri[1] for ri in r)
                    hap = 0 if in_par else 2
                elif re.match(r"^(chr)?Y", t[0]):
                    hap = 1
            if hap > 0 and len(FILTER) == 1:
                if ((hap == 2 and FILTER[0] == "GAP1")
                        or (hap == 1 and FILTER[0] == "GAP2")):
                    FILTER = []
            t[5] = "30"
            t[6] = ";".join(FILTER) if FILTER else "."
            t[9] = "|".join(HT) + ":" + ",".join(map(str, AD))
            o.write("\t".join(t) + "\n")
    return 0


# ---------------------------------------------------------------------------
# vcfsel (paftools.js:2961-2997) + shared allele-length helper (2806-2821)
# ---------------------------------------------------------------------------

def _get_alen(t):
    """(alen, min_abs_diff, max_abs_diff) from a VCF row
    (_paf_get_alen, paftools.js:2806-2821)."""
    svlen = alen = None
    m = re.search(r"(^|;)SVLEN=(-?\d+)", t[7])
    if m:
        svlen = int(m.group(2))
    min_abs, max_abs = 1 << 30, 0
    if svlen is not None and svlen != 0:
        alen = svlen
        min_abs = max_abs = abs(svlen)
    rlen = len(t[3])
    for s in t[4].split(","):
        if re.match(r"^<\S+>$", s):
            continue
        diff = len(s) - rlen
        ad = abs(diff)
        min_abs = min(min_abs, ad)
        if max_abs < ad:
            max_abs, alen = ad, diff
    return alen, min_abs, max_abs


def vcfsel(argv) -> int:
    """Select VCF records by allele length difference."""
    ap = argparse.ArgumentParser(prog="paftools vcfsel")
    ap.add_argument("-l", dest="min_l", type=int, default=0)
    ap.add_argument("-L", dest="max_l", type=int, default=1 << 30)
    ap.add_argument("vcf", nargs="?", default="-")
    args = ap.parse_args(argv)
    o = sys.stdout
    with _open(args.vcf) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("#"):
                o.write(line + "\n")
                continue
            t = line.split("\t")
            st = int(t[1])
            en = st + len(t[3]) - 1
            m = re.search(r"(^|;)END=(\d+)", t[7])
            if m:
                en = int(m.group(2))
            if en < st:
                sys.stderr.write(f"END is smaller than POS: {en} < "
                                 f"{st}\n")
            _alen, min_abs, max_abs = _get_alen(t)
            if max_abs < args.min_l or min_abs > args.max_l:
                continue
            o.write(line + "\n")
    return 0


# ---------------------------------------------------------------------------
# sveval (paftools.js:2823-2959)
# ---------------------------------------------------------------------------

def _fmt6(v: float) -> str:
    import math
    if v != v:
        return "NaN"
    s = 1 if v >= 0 else -1
    return f"{s * math.floor(abs(v) * 1e6 + 0.5) / 1e6:.6f}"


def sveval(argv) -> int:
    """Compare two SV callsets in VCF (SN/PC/F1)."""
    ap = argparse.ArgumentParser(prog="paftools sveval")
    ap.add_argument("-f", dest="min_flt", type=_parse_num, default=30)
    ap.add_argument("-i", dest="min_size", type=_parse_num, default=50)
    ap.add_argument("-x", dest="max_size", type=_parse_num, default=100000)
    ap.add_argument("-w", dest="win_size", type=_parse_num, default=500)
    ap.add_argument("-d", dest="len_diff_ratio", type=float, default=0.5)
    ap.add_argument("-r", dest="bed_fn", default=None)
    ap.add_argument("-e", dest="print_err", action="store_true")
    ap.add_argument("-p", dest="print_match", action="store_true")
    ap.add_argument("base_vcf")
    ap.add_argument("call_vcf")
    args = ap.parse_args(argv)

    bed = None
    if args.bed_fn:
        bed = {}
        with _open(args.bed_fn) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                bed.setdefault(t[0], []).append([int(t[1]), int(t[2])])
        for x in bed:
            _iv_sort(bed[x])
            _iv_merge(bed[x])
            _iv_index_end(bed[x])

    def read_vcf(fn):
        v: dict = {}
        with _open(fn) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                if t[0].startswith("#"):
                    continue
                if bed is not None and t[0] not in bed:
                    continue
                if t[4] in ("<INV>", "<INVDUP>"):
                    continue
                if re.search(r"[\[\]]", t[4]):
                    continue
                st = int(t[1]) - 1
                en = st + len(t[3])
                svlen, _mn, _mx = _get_alen(t)
                abslen = 0 if svlen is None else abs(svlen)
                if abslen < args.min_flt or abslen > args.max_size:
                    continue
                m = re.search(r"(^|;)END=(\d+)", t[7])
                if m:
                    en = int(m.group(2))
                elif svlen is not None and svlen < 0:
                    en = st + (-svlen)
                if en < st:
                    en = st
                if st == en:
                    st -= 1
                    en += 1
                if bed is not None and \
                        not _iv_find_ovlp(bed[t[0]], st, en):
                    continue
                v.setdefault(t[0], []).append([st, en, svlen, abslen])
        for x in v:
            _iv_sort(v[x])
            _iv_index_end(v[x])
        return v

    def compare_vcf(v0, v1, label):
        m_cnt = n_cnt = 0
        for x, a1 in v1.items():
            a0 = v0.get(x)
            for r in a1:
                if r[3] < args.min_size:
                    continue
                n_cnt += 1
                if a0 is None:
                    continue
                ws = args.win_size + (r[3] >> 1)
                st = r[0] - ws if r[0] > ws else 0
                b = _iv_find_ovlp(a0, st, r[1] + ws)
                n_ins = n_del = 0
                sv_del = sv_ins = None
                for bj in b:
                    if bj[2] < 0:
                        n_del += 1
                        sv_del = -bj[2]
                    elif bj[2] > 0:
                        n_ins += 1
                        sv_ins = bj[2]
                    if args.print_match:
                        _p("MA", x, "\t".join(map(str, r[:3])),
                           "\t".join(map(str, bj[:3])))
                match = False
                if r[2] is not None and r[2] > 0:
                    if n_ins == 1:
                        diff = abs(sv_ins - r[3])
                        if (diff < args.min_size
                                or diff / r[3] < args.len_diff_ratio):
                            match = True
                    elif n_ins > 1:
                        match = True
                elif r[2] is not None and r[2] < 0:
                    if n_del == 1:
                        diff = abs(sv_del - r[3])
                        if (diff < args.min_size
                                or diff / r[3] < args.len_diff_ratio):
                            match = True
                    elif n_del > 1:
                        match = True
                if match:
                    m_cnt += 1
                elif args.print_err:
                    if ((r[2] is not None and r[2] > 0 and n_ins > 0)
                            or (r[2] is not None and r[2] < 0
                                and n_del > 0)):
                        _p("MM", x, "\t".join(map(str, r[:3])))
                    _p(label, x, "\t".join(map(str, r[:3])))
        return n_cnt, m_cnt

    v_base = read_vcf(args.base_vcf)
    v_call = read_vcf(args.call_vcf)
    fn = compare_vcf(v_call, v_base, "FN")
    fp = compare_vcf(v_base, v_call, "FP")
    sn = fn[1] / fn[0] if fn[0] else float("nan")
    pc = fp[1] / fp[0] if fp[0] else float("nan")
    _p("SN", fn[0], fn[1], _fmt6(sn))
    _p("PC", fp[0], fp[1], _fmt6(pc))
    _p("F1", _fmt6((sn + pc) / 2))
    return 0


# ---------------------------------------------------------------------------
# asmstat (paftools.js:566-818)
# ---------------------------------------------------------------------------

def _fmt0(v: float) -> str:
    import math
    return str(math.floor(v + 0.5) if v >= 0 else -math.floor(-v + 0.5))


def asmstat(argv) -> int:
    """Assembly statistics from asm-to-ref PAF(s)."""
    ap = argparse.ArgumentParser(prog="paftools asmstat")
    ap.add_argument("-q", dest="min_query_len", type=int, default=0)
    ap.add_argument("-l", dest="min_seg_len", type=int, default=10000)
    ap.add_argument("-d", dest="max_diff", type=float, default=0.01)
    ap.add_argument("-b", dest="bp_flank_len", type=int, default=0)
    ap.add_argument("-g", dest="bp_gap_len", type=int, default=0)
    ap.add_argument("fai")
    ap.add_argument("pafs", nargs="+")
    args = ap.parse_args(argv)

    ref_len = 0
    with _open(args.fai) as f:
        for line in f:
            ref_len += int(line.split("\t")[1])

    def process_query(qblocks, qblock_len, bp, qi):
        qblocks.sort(key=lambda b: b[0])
        last_k = last_blen = None
        st = en = -1
        qcov = 0
        for k, qb in enumerate(qblocks):
            blen = qb[1] - qb[0]
            if k > 0 and qb[0] < qblocks[k - 1][1]:
                if qb[1] < qblocks[k - 1][1]:
                    continue
                blen = qb[1] - qblocks[k - 1][1]
            qblock_len.append(blen)
            if qb[0] > en:
                qcov += en - st
                st, en = qb[0], qb[1]
            else:
                en = max(en, qb[1])
            if last_k is not None:
                gap = 1000000000
                lk = qblocks[last_k]
                if qb[2] == lk[2] and qb[3] == lk[3]:
                    g1 = qb[0] - lk[1]
                    g2 = (qb[4] - lk[5] if qb[2] == "+"
                          else lk[4] - qb[5])
                    gap = abs(g1 - g2)
                bp.append([blen, gap])
                qi["bp"].append([blen, gap])
            last_k, last_blen = k, blen
        del last_blen
        qcov += en - st
        return qcov

    def n50(lens, tot, quantile):
        lens.sort(reverse=True)
        if tot is None:
            tot = sum(lens)
        s = 0
        for ln in lens:
            if s <= quantile * tot < s + ln:
                return ln
            s += ln
        return None  # JS: undefined -> "" in Array.join

    def aun(lens, tot):
        lens.sort(reverse=True)
        if tot is None:
            tot = sum(lens)
        x = y = 0.0
        for ln in lens:
            le = ln if x + ln <= tot else tot - x
            x += ln
            y += le * (le / tot)
            if x >= tot:
                break
        return _fmt0(y)

    def count_bp(bp, min_blen, min_gap):
        return sum(1 for b in bp if b[0] >= min_blen and b[1] >= min_gap)

    def compute_diff(cigar, nm):
        n_m = n_gapo = n_gaps = 0
        for m in re.finditer(r"(\d+)([MID])", cigar):
            ln = int(m.group(1))
            if m.group(2) == "M":
                n_m += ln
            else:
                n_gapo += 1
                n_gaps += ln
        if nm < n_gaps:
            raise SystemExit("NM is smaller the number of gaps")
        return (nm - n_gaps + n_gapo) / (n_m + n_gapo)

    labels = ["Length", "l_cov", "Rcov", "Rdup", "Qcov", "NG75", "NG50",
              "NGA50", "AUNGA", "#breaks",
              f"bp({args.min_seg_len},0)", f"bp({args.min_seg_len},10k)"]
    rst = [[] for _ in labels]
    header = ["Metric"]
    for fn in args.pafs:
        header.append(re.sub(r".paf(.gz)?$", "", fn))
        n_breaks = qcov = 0
        ref_blocks, qblock_len, qblocks, bp = [], [], [], []
        query, qinfo = {}, {}
        last_qname = None
        with _open(fn) as f:
            for line in f:
                line = line.rstrip("\n")
                t = line.split("\t")
                if len(t) < 2:
                    continue
                t1 = int(t[1])
                if t1 < args.min_query_len:
                    continue
                query[t[0]] = t1
                qinfo.setdefault(t[0], {})["len"] = t1
                qinfo[t[0]]["bp"] = qinfo[t[0]].get("bp", [])
                if len(t) < 9 or t[5] == "*":
                    continue
                if not re.search(r"\ttp:A:[PI]", line):
                    continue
                m = re.search(r"\tcg:Z:(\S+)", line)
                cigar = m.group(1) if m else None
                m = re.search(r"\tNM:i:(\d+)", line)
                nm = int(m.group(1)) if m else None
                diff = (compute_diff(cigar, nm)
                        if cigar is not None and nm is not None else 0)
                qs, qe = int(t[2]), int(t[3])
                ts_, te_ = int(t[7]), int(t[8])
                if t[0] == last_qname:
                    n_breaks += 1
                if diff > args.max_diff:
                    continue
                if qe - qs < args.min_seg_len:
                    continue
                if t[0] != last_qname:
                    if last_qname is not None:
                        qcov += process_query(qblocks, qblock_len, bp,
                                              qinfo[last_qname])
                    qblocks = []
                    last_qname = t[0]
                ref_blocks.append([t[5], ts_, te_])
                qblocks.append([qs, qe, t[4], t[5], ts_, te_])
        if last_qname is not None:
            qcov += process_query(qblocks, qblock_len, bp,
                                  qinfo[last_qname])

        asm_lens = list(query.values())
        asm_len = sum(asm_lens)
        rst[0].append(asm_len)
        rst[5].append(n50(asm_lens, ref_len, 0.75))
        rst[6].append(n50(list(asm_lens), ref_len, 0.5))

        l_cov = 0
        ref_blocks.sort(key=lambda b: (b[0], b[1]))
        last_ref, st, en = None, -1, -1
        for rb in ref_blocks:
            if rb[0] != last_ref or rb[1] > en:
                l_cov += en - st
                last_ref, st, en = rb[0], rb[1], rb[2]
            else:
                en = max(en, rb[2])
        l_cov += en - st
        rst[1].append(l_cov)
        rst[2].append(_fmt2(100.0 * l_cov / ref_len) + "%")
        rst[4].append(_fmt2(100.0 * qcov / asm_len) + "%"
                      if asm_len else "NaN%")

        c1_ctg, c1_start, c1_end, c1_len = None, 0, 0, 0
        for rb in ref_blocks:
            if rb[0] != c1_ctg or rb[1] >= c1_end:
                if c1_end > c1_start:
                    c1_len += c1_end - c1_start
                c1_ctg, c1_start, c1_end = rb[0], rb[1], rb[2]
            elif rb[2] > c1_end:
                if rb[1] > c1_start:
                    c1_len += rb[1] - c1_start
                c1_start, c1_end = c1_end, rb[2]
            elif rb[2] > c1_start:
                if rb[1] > c1_start:
                    c1_len += rb[1] - c1_start
                c1_start = rb[2]
        if c1_end > c1_start:
            c1_len += c1_end - c1_start
        rst[3].append(_fmt2(100 * (l_cov - c1_len) / l_cov) + "%"
                      if l_cov else "NaN%")
        rst[7].append(n50(qblock_len, ref_len, 0.5))
        rst[8].append(aun(qblock_len, ref_len))
        rst[9].append(n_breaks)
        rst[10].append(count_bp(bp, 500, 0))
        rst[11].append(count_bp(bp, 500, 10000))

    if args.bp_flank_len <= 0:
        sys.stdout.write("\t".join(header) + "\n")
        for i, lab in enumerate(labels):
            _p(lab, "\t".join("" if v is None else str(v)
                              for v in rst[i]))
    return 0


# ---------------------------------------------------------------------------
# asmgene (paftools.js:820-961)
# ---------------------------------------------------------------------------

def asmgene(argv) -> int:
    """Gene completeness from cDNA-to-ref and cDNA-to-asm splice PAFs."""
    ap = argparse.ArgumentParser(prog="paftools asmgene")
    ap.add_argument("-i", dest="min_iden", type=float, default=0.99)
    ap.add_argument("-c", dest="min_cov", type=float, default=0.99)
    ap.add_argument("-e", dest="print_err", action="store_true")
    ap.add_argument("-a", dest="auto_only", action="store_true")
    ap.add_argument("pafs", nargs="+")
    args = ap.parse_args(argv)
    if len(args.pafs) < 2:
        raise SystemExit("asmgene needs <ref-splice.paf> <asm-splice.paf>")

    def process_query(a):
        b = [list(r) for r in a if r[4] >= r[5] * args.min_iden]
        cnt = [0, 0, 0]
        if not b:
            return cnt
        cnt[0] = sum(1 for r in b if r[3] - r[2] >= r[1] * args.min_cov)
        b.sort(key=lambda r: r[2])
        l_cov, st, en = 0, b[0][2], b[0][3]
        for r in b[1:]:
            if r[2] <= en:
                en = max(en, r[3])
            else:
                # the reference never restarts (st, en) here
                # (paftools.js:858-861) — replicated verbatim
                l_cov += en - st
        l_cov += en - st
        cnt[1] = l_cov / b[0][1]
        cnt[2] = len(b)
        return cnt

    gene: dict = {}
    refpos: dict = {}
    header = []
    n_fn = len(args.pafs)
    for i, fn in enumerate(args.pafs):
        header.append(re.sub(r".paf(.gz)?$", "", fn))
        a: list = []
        t = None
        with _open(fn) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                ql, qs, qe = int(t[1]), int(t[2]), int(t[3])
                mlen, blen = int(t[9]), int(t[10])
                if i == 0:
                    refpos[t[0]] = [t[0], t[1], t[5], int(t[7]),
                                    int(t[8])]
                g = gene.setdefault(t[0], [None] * n_fn)
                del g
                if a and t[0] != a[0][0]:
                    gene[a[0][0]][i] = process_query(a)
                    a = []
                a.append([t[0], ql, qs, qe, mlen, blen])
        if a:
            gene[t[0]][i] = process_query(a)

    gene_list = sorted(refpos.values(),
                       key=lambda r: (r[2], r[3]))
    gene_nr: dict = {}
    last = 0
    for j in range(1, len(gene_list)):
        if (gene_list[j][2] != gene_list[last][2]
                or gene_list[j][3] >= gene_list[last][4]):
            gene_nr[gene_list[last][0]] = 1
            last = j
        elif gene_list[j][1] > gene_list[last][1]:
            last = j
    gene_nr[gene_list[last][0]] = 1

    col1 = ["full_sgl", "full_dup", "frag", "part50+", "part10+",
            "part10-", "dup_cnt", "dup_sum"]
    rst = [[0] * n_fn for _ in col1]
    xy_re = re.compile(r"^(chr)?[XY]$")

    def refjoin(g):
        return "\t".join(map(str, refpos[g]))

    for g, recs in gene.items():  # single-copy genes
        if recs[0] is None or recs[0][0] != 1:
            continue
        if g not in gene_nr:
            continue
        if args.auto_only and xy_re.match(refpos[g][2]):
            continue
        for i in range(n_fn):
            gi = recs[i]
            if gi is None:
                rst[5][i] += 1
                if args.print_err:
                    _p("M", header[i], refjoin(g))
            elif gi[0] == 1:
                rst[0][i] += 1
            elif gi[0] > 1:
                rst[1][i] += 1
                if args.print_err:
                    _p("D", header[i], refjoin(g))
            elif gi[1] >= args.min_cov:
                rst[2][i] += 1
                if args.print_err:
                    _p("F", header[i], refjoin(g))
            elif gi[1] >= 0.5:
                rst[3][i] += 1
                if args.print_err:
                    _p("5", header[i], refjoin(g))
            elif gi[1] >= 0.1:
                rst[4][i] += 1
                if args.print_err:
                    _p("1", header[i], refjoin(g))
            else:
                rst[5][i] += 1
                if args.print_err:
                    _p("0", header[i], refjoin(g))
    for g, recs in gene.items():  # multi-copy genes
        if recs[0] is None or recs[0][0] <= 1:
            continue
        if g not in gene_nr:
            continue
        if args.auto_only and xy_re.match(refpos[g][2]):
            continue
        for i in range(n_fn):
            if recs[i] is not None:
                rst[7][i] += recs[i][0]
            if recs[i] is not None and recs[i][0] > 1:
                rst[6][i] += 1
            elif args.print_err:
                _p("d", header[i], recs[0][0], refjoin(g))
    _p("H", "Metric", "\t".join(header))
    for k, c in enumerate(col1):
        _p("X", c, "\t".join(map(str, rst[k])))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmds = {"mapeval": mapeval, "stat": stat, "sam2paf": sam2paf,
            "liftover": liftover, "liftOver": liftover, "call": call,
            "view": view, "junceval": junceval, "bedcov": bedcov,
            "vcfstat": vcfstat, "pafcmp": pafcmp, "misjoin": misjoin,
            "ov-eval": ov_eval, "version": version, "gff2bed": gff2bed,
            "splice2bed": splice2bed, "delta2paf": delta2paf,
            "mason2fq": mason2fq, "pbsim2fq": pbsim2fq,
            "vcfpair": vcfpair, "vcfsel": vcfsel, "asmstat": asmstat,
            "asmgene": asmgene, "sveval": sveval}
    if not argv or argv[0] not in cmds:
        sys.stderr.write(__doc__ + "\n")
        return 1
    return cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
