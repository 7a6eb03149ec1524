# Frozen copy of mm2_gb_tpu_torch/utils/sam.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""SAM output + cs/MD difference strings (format.c analogs).

Byte-exact with mm_write_sam3 (format.c:389-546), mm_write_sam_hdr
(format.c:118-139) and write_cs_core / write_MD_core (format.c:141-218).
"""

from __future__ import annotations

import numpy as np

from .hit import Region
from .sketch import _NT4
from .fastx import SeqRecord
from .opts import (MM_F_COPY_COMMENT, MM_F_LONG_CIGAR,
                                   MM_F_NO_QUAL, MM_F_OUT_CS,
                                   MM_F_OUT_CS_LONG, MM_F_OUT_MD,
                                   MM_F_SOFTCLIP)

# @PG VN: value.  The byte contract includes the SAM header, so the
# default is the reference binary's MM_VERSION (main.c:15); set
# MM2TPU_PG_VN to brand the header with this package's own version.
import os as _os  # noqa: E402

PG_VN = _os.environ.get("MM2TPU_PG_VN", "2.24-mm2-gb-biosys")

CIGAR_STR = "MIDNSHP=XB"
_COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "a": "t", "c": "g",
         "g": "c", "t": "a", "U": "A", "u": "a", "R": "Y", "Y": "R",
         "r": "y", "y": "r", "K": "M", "M": "K", "k": "m", "m": "k",
         "B": "V", "V": "B", "b": "v", "v": "b", "D": "H", "H": "D",
         "d": "h", "h": "d", "S": "S", "s": "s", "W": "W", "w": "w",
         "N": "N", "n": "n"}


def _revcomp_str(s: str) -> str:
    return "".join(_COMP.get(c, c) for c in reversed(s))


def write_sam_header(index, rg: str | None, ver: str,
                     cli_args: list[str] | None) -> str:
    """@SQ + @PG lines (mm_write_sam_hdr, format.c:118-139).

    index=None omits the @SQ lines (mm_write_sam_hdr(0,...) — the
    split-prefix / multi-part header shape, main.c:415-419)."""
    lines = []
    if index is not None:
        for i in range(index.n_seq):
            lines.append(
                f"@SQ\tSN:{index.names[i]}\tLN:{int(index.lens[i])}")
    if rg:
        lines.append(rg.replace("\\t", "\t"))
    pg = f"@PG\tID:minimap2\tPN:minimap2\tVN:{ver}"
    if cli_args:
        pg += "\tCL:minimap2 " + " ".join(cli_args)
    lines.append(pg)
    return "\n".join(lines)


def _region_seqs(index, qseq_str: str, r: Region, is_qstrand: bool):
    """Aligned-region (tseq, qseq) base codes (write_cs_or_MD, format.c:220-249)."""
    q = _NT4[np.frombuffer(qseq_str.encode(), np.uint8)]
    if is_qstrand:
        tseq = index.get_seq(r.rid, r.rs, r.re, rev=bool(r.rev))
        qseq = q[r.qs:r.qe]
    else:
        tseq = index.get_seq(r.rid, r.rs, r.re)
        if not r.rev:
            qseq = q[r.qs:r.qe]
        else:
            qseq = q[r.qs:r.qe]
            qseq = np.where(qseq >= 4, np.uint8(4), 3 - qseq)[::-1]
    return tseq, qseq


def write_cs_or_md(index, qseq_str: str, r: Region, no_iden: bool,
                   is_md: bool, write_tag: bool, is_qstrand: bool) -> str:
    """cs:Z: or MD:Z: difference string (format.c:141-218)."""
    if r.p is None:
        return ""
    tseq, qseq = _region_seqs(index, qseq_str, r, is_qstrand)
    L = "acgtn"
    U = "ACGTN"
    out = []
    if write_tag:
        out.append("\tMD:Z:" if is_md else "\tcs:Z:")
    q_off = t_off = 0
    l_md = 0
    for c in r.p.cigar:
        op, ln = int(c) & 0xF, int(c) >> 4
        if op in (0, 7, 8):  # M / = / X
            ts = tseq[t_off:t_off + ln]
            qs = qseq[q_off:q_off + ln]
            if is_md:
                for j in range(ln):
                    if qs[j] != ts[j]:
                        out.append(f"{l_md}{U[ts[j]]}")
                        l_md = 0
                    else:
                        l_md += 1
            else:
                run = []
                for j in range(ln):
                    if qs[j] != ts[j]:
                        if run:
                            out.append("=" + "".join(run) if not no_iden
                                       else f":{len(run)}")
                            run = []
                        out.append(f"*{L[ts[j]]}{L[qs[j]]}")
                    else:
                        run.append(U[qs[j]])
                if run:
                    out.append("=" + "".join(run) if not no_iden
                               else f":{len(run)}")
            q_off += ln
            t_off += ln
        elif op == 1:  # I
            if not is_md:
                out.append("+" + "".join(L[b] for b in qseq[q_off:q_off + ln]))
            q_off += ln
        elif op == 2:  # D
            if is_md:
                out.append(f"{l_md}^" + "".join(
                    U[b] for b in tseq[t_off:t_off + ln]))
                l_md = 0
            else:
                out.append("-" + "".join(L[b] for b in tseq[t_off:t_off + ln]))
            t_off += ln
        else:  # N (intron)
            if not is_md:
                out.append(f"~{L[tseq[t_off]]}{L[tseq[t_off + 1]]}{ln}"
                           f"{L[tseq[t_off + ln - 2]]}{L[tseq[t_off + ln - 1]]}")
            t_off += ln
    if is_md and l_md > 0:
        out.append(str(l_md))
    assert t_off == r.re - r.rs and q_off == r.qe - r.qs
    return "".join(out)


def _sam_cigar(flag: int, qlen: int, r: Region, opt_flag: int) -> str:
    """CIGAR column with clips (write_sam_cigar, format.c:363-387)."""
    if r.p is None:
        return "*"
    clip0 = qlen - r.qe if r.rev else r.qs
    clip1 = r.qs if r.rev else qlen - r.qe
    clip_char = "H" if (flag & 0x800) and not (opt_flag & MM_F_SOFTCLIP) \
        else "S"
    parts = []
    if clip0:
        parts.append(f"{clip0}{clip_char}")
    for c in r.p.cigar:
        parts.append(f"{int(c) >> 4}{CIGAR_STR[int(c) & 0xF]}")
    if clip1:
        parts.append(f"{clip1}{clip_char}")
    return "".join(parts)


def _qname_len(s: str) -> int:
    """Trim /1-/9 suffixes (mm_qname_len, bseq.h:31-36)."""
    l = len(s)
    return l - 2 if l >= 3 and s[-1].isdigit() and s[-2] == "/" else l


def _get_sam_pri(regs: list[Region]) -> Region | None:
    for r in regs:
        if r.sam_pri:
            return r
    return None


def write_sam_record(index, rec: SeqRecord, reg_idx: int,
                     regs: list[Region], opt_flag: int, rep_len: int,
                     rg_id: str | None = None, seg_idx: int = 0,
                     n_seg: int = 1, regss: "list[list[Region]] | None" = None
                     ) -> str:
    """One SAM line (mm_write_sam3, format.c:389-546)."""
    qlen = rec.length
    if opt_flag & MM_F_NO_QUAL:  # -Q: reader drops quality (map.c:1275)
        rec = SeqRecord(rec.rid, rec.name, rec.seq, None, rec.comment)
    r = regs[reg_idx] if regs and 0 <= reg_idx < len(regs) else None

    # primaries of the previous/next segments (format.c:397-410)
    r_prev = r_next = None
    if n_seg > 1:
        nxt = (seg_idx + 1) % n_seg
        r_next = _get_sam_pri(regss[nxt]) if regss[nxt] else None
        if n_seg > 2:
            for i in range(1, n_seg):
                prev = (seg_idx + n_seg - i) % n_seg
                if regss[prev]:
                    r_prev = _get_sam_pri(regss[prev])
                    break
        else:
            r_prev = r_next

    qname = rec.name if n_seg == 1 else rec.name[:_qname_len(rec.name)]
    out = [qname]
    flag = 0x1 if n_seg > 1 else 0x0
    if r is None:
        flag |= 0x4
    else:
        if r.rev:
            flag |= 0x10
        if r.parent != r.id:
            flag |= 0x100
        elif not r.sam_pri:
            flag |= 0x800
    if n_seg > 1:
        if r is not None and r.proper_frag:
            flag |= 0x2
        if seg_idx == 0:
            flag |= 0x40
        elif seg_idx == n_seg - 1:
            flag |= 0x80
        if r_next is None:
            flag |= 0x8
        elif r_next.rev:
            flag |= 0x20
    out.append(str(flag))

    this_rid = this_pos = -1
    if r is None:
        if r_prev is not None:
            this_rid, this_pos = r_prev.rid, r_prev.rs
            out.append(f"{index.names[this_rid]}\t{this_pos + 1}\t0\t*")
        else:
            out.append("*\t0\t0\t*")
    else:
        this_rid, this_pos = r.rid, r.rs
        out.append(f"{index.names[r.rid]}\t{r.rs + 1}\t{r.mapq}\t"
                   + _sam_cigar(flag, qlen, r, opt_flag))
    if n_seg > 1:  # mate columns (format.c:461-481)
        tlen = 0
        if this_rid >= 0 and r_next is not None:
            if this_rid == r_next.rid:
                if r is not None:
                    p5 = r.re - 1 if r.rev else this_pos
                    n5 = r_next.re - 1 if r_next.rev else r_next.rs
                    tlen = n5 - p5
                out.append(f"=\t{r_next.rs + 1}")
            else:
                out.append(f"{index.names[r_next.rid]}\t{r_next.rs + 1}")
        elif r_next is not None:
            out.append(f"{index.names[r_next.rid]}\t{r_next.rs + 1}")
        elif this_rid >= 0:
            out.append(f"=\t{this_pos + 1}")
        else:
            out.append("*\t0")
        if tlen > 0:
            tlen += 1
        elif tlen < 0:
            tlen -= 1
        out.append(str(tlen))
    else:
        out.append("*\t0\t0")

    if r is None:
        out.append(rec.seq)
        out.append(rec.qual if rec.qual else "*")
    elif (flag & 0x900) == 0 or (opt_flag & MM_F_SOFTCLIP):
        out.append(_revcomp_str(rec.seq) if r.rev else rec.seq)
        if rec.qual:
            out.append(rec.qual[::-1] if r.rev else rec.qual)
        else:
            out.append("*")
    elif flag & 0x100:
        out.append("*")
        out.append("*")
    else:
        seg = rec.seq[r.qs:r.qe]
        out.append(_revcomp_str(seg) if r.rev else seg)
        if rec.qual:
            qseg = rec.qual[r.qs:r.qe]
            out.append(qseg[::-1] if r.rev else qseg)
        else:
            out.append("*")

    s = "\t".join(out)
    if rg_id:
        s += f"\tRG:Z:{rg_id}"
    if r is not None:
        from .paf import _tags
        s += _tags(r)
        # SA tag over co-primary alignments (format.c:510-534)
        if r.parent == r.id and r.p is not None and len(regs) > 1:
            sa = []
            for q in regs:
                if q is r or q.parent != q.id or q.p is None:
                    continue
                if q.qe - q.qs < q.re - q.rs:
                    l_m = q.qe - q.qs
                    l_i, l_d = 0, (q.re - q.rs) - l_m
                else:
                    l_m = q.re - q.rs
                    l_i, l_d = (q.qe - q.qs) - l_m, 0
                clip5 = qlen - q.qe if q.rev else q.qs
                clip3 = q.qs if q.rev else qlen - q.qe
                cig = ""
                if clip5:
                    cig += f"{clip5}S"
                if l_m:
                    cig += f"{l_m}M"
                if l_i:
                    cig += f"{l_i}I"
                if l_d:
                    cig += f"{l_d}D"
                if clip3:
                    cig += f"{clip3}S"
                nm = q.blen - q.mlen + q.p.n_ambi
                sa.append(f"{index.names[q.rid]},{q.rs + 1},"
                          f"{'-' if q.rev else '+'},{cig},{q.mapq},{nm};")
            if sa:
                s += "\tSA:Z:" + "".join(sa)
        if r.p is not None and (opt_flag & (MM_F_OUT_CS | MM_F_OUT_MD)):
            s += write_cs_or_md(index, rec.seq, r,
                                not (opt_flag & MM_F_OUT_CS_LONG),
                                bool(opt_flag & MM_F_OUT_MD), True, False)
    if rep_len >= 0:
        s += f"\trl:i:{rep_len}"
    if (opt_flag & MM_F_COPY_COMMENT) and rec.comment:
        s += f"\t{rec.comment}"
    return s
