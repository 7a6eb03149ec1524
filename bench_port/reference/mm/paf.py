# Frozen copy of mm2_gb_tpu_torch/utils/paf.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""PAF output formatting (byte-exact with the reference's format.c).

Field and tag order reproduces mm_write_paf3 (format.c:302-334) and
write_tags (format.c:274-300).
"""

from __future__ import annotations

from .hit import Region
from .opts import (MM_F_OUT_CG, MM_F_OUT_CS, MM_F_OUT_CS_LONG,
                                   MM_F_OUT_MD, MM_F_QSTRAND,
                                   MM_F_COPY_COMMENT)

CIGAR_STR = "MIDNSHP=XB"


def _fmt_div(div: float) -> str:
    # format.c:289-292: exact zero prints "0", otherwise %.4f.  glibc
    # %.4f spells NaN/inf with their sign; CPython's formatter drops the
    # NaN sign, so spell them out (zeroed regs from merged split dumps
    # produce -nan here).
    import math
    if div == 0.0:
        return "0"
    if math.isnan(div):
        return "-nan" if math.copysign(1.0, div) < 0 else "nan"
    if math.isinf(div):
        return "-inf" if div < 0 else "inf"
    return "%.4f" % div


def _event_identity(r: Region) -> float:
    """mm_event_identity (align.c:909-915): gap runs counted as one event.

    A calloc-zeroed reg (merged split dumps past EOF, see splitmerge.py)
    divides 0/0; x86 SSE produces the negative default QNaN, which the
    de:f tag then prints as "-nan" — replicated via math.copysign."""
    if r.p is None:
        return -1.0
    n_gap = n_gapo = 0
    for c in r.p.cigar:
        op, ln = int(c) & 0xF, int(c) >> 4
        if op in (1, 2):  # I or D
            n_gapo += 1
            n_gap += ln
    den = r.blen + r.p.n_ambi - n_gap + n_gapo
    if den == 0:
        import math
        if r.mlen == 0:
            return math.copysign(float("nan"), -1.0)
        return math.copysign(float("inf"), r.mlen)
    return float(r.mlen) / den


def write_paf(r: Region | None, qname: str, qlen: int, index,
              opt_flag: int, rep_len: int, comment: str | None = None,
              qseq: str | None = None) -> str:
    """One PAF line (no trailing newline)."""
    if r is None:
        s = f"{qname}\t{qlen}\t0\t0\t*\t*\t0\t0\t0\t0\t0\t0"
        if rep_len >= 0:
            s += f"\trl:i:{rep_len}"
        return s
    out = [qname, str(qlen), str(r.qs), str(r.qe), "-" if r.rev else "+"]
    rname = index.names[r.rid]
    out.append(rname if rname is not None else str(r.rid))
    rlen = int(index.lens[r.rid])
    out.append(str(rlen))
    if (opt_flag & MM_F_QSTRAND) and r.rev:
        out.append(str(rlen - r.re))
        out.append(str(rlen - r.rs))
    else:
        out.append(str(r.rs))
        out.append(str(r.re))
    out.append(str(r.mlen))
    out.append(str(r.blen))
    out.append(str(r.mapq))
    s = "\t".join(out)
    s += _tags(r)
    if rep_len >= 0:
        s += f"\trl:i:{rep_len}"
    if r.p is not None and (opt_flag & MM_F_OUT_CG):
        cg = "".join(f"{int(c) >> 4}{CIGAR_STR[int(c) & 0xF]}" for c in r.p.cigar)
        s += f"\tcg:Z:{cg}"
    if r.p is not None and (opt_flag & (MM_F_OUT_CS | MM_F_OUT_MD)) \
            and qseq is not None:
        from .sam import write_cs_or_md
        s += write_cs_or_md(index, qseq, r, not (opt_flag & MM_F_OUT_CS_LONG),
                            bool(opt_flag & MM_F_OUT_MD), True,
                            bool(opt_flag & MM_F_QSTRAND))
    if (opt_flag & MM_F_COPY_COMMENT) and comment:
        s += f"\t{comment}"
    return s


def _tags(r: Region) -> str:
    """Standard tag block (write_tags, format.c:274-300)."""
    if r.id == r.parent:
        tp = "I" if r.inv else "P"
    else:
        tp = "i" if r.inv else "S"
    s = ""
    if r.p is not None:
        s += (f"\tNM:i:{r.blen - r.mlen + r.p.n_ambi}\tms:i:{r.p.dp_max}"
              f"\tAS:i:{r.p.dp_score}\tnn:i:{r.p.n_ambi}")
        if r.p.trans_strand in (1, 2):
            s += f"\tts:A:{'?+-?'[r.p.trans_strand]}"
    s += f"\ttp:A:{tp}\tcm:i:{r.cnt}\ts1:i:{r.score}"
    if r.parent == r.id:
        s += f"\ts2:i:{r.subsc}"
    if r.p is not None:
        s += f"\tde:f:{_fmt_div(1.0 - _event_identity(r))}"
    elif 0.0 <= r.div <= 1.0:
        s += f"\tdv:f:{_fmt_div(r.div)}"
    if r.split:
        s += f"\tzd:i:{r.split}"
    return s
