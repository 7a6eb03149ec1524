"""Each read's records held to where the read came from.

The read generator (gen/reads.py) names a read chrom_index_start_length
and its strand ('+' or '-'): it copied genome[start:start + length] of
chromosome chrom, with errors, and reverse-complemented it for '-'.
`off` reads the primary SAM record the program wrote for the read (the
line whose flag has neither 0x100 nor 0x800) and says whether it is a
confident wrong answer: no primary record, an unmapped one, or one at MAPQ 1 or more on another
chromosome, on the other strand, or on a span that does not overlap the
read's origin.  A primary record at MAPQ 0 places the read among equal
copies, and claims no position.

This holds the whole path, the writer of the records included, to
something other than a copy of the program's own code: the generator's
record of each read's origin.
"""

from __future__ import annotations

import re

_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")
_REF_OPS = frozenset("MDN=X")


def origin(name: str) -> tuple[str, int, int, bool]:
    """(chromosome, start, end, reverse) of a read the generator named."""
    chrom, _i, start, rest = name.rsplit("_", 3)
    return chrom, int(start), int(start) + int(rest[:-1]), rest[-1] == "-"


def primary(text: str, sam: bool = True):
    """(chromosome, start, end, reverse, mapq) of the read's primary
    record in `text` (its SAM lines, or its PAF lines where `sam` is
    false), or None where it has none or it is unmapped."""
    if not sam:
        return _paf_primary(text)
    for line in text.splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t", 6)
        flag = int(f[1])
        if flag & 0x900:
            continue
        if flag & 0x4:
            return None
        start = int(f[3]) - 1
        span = sum(int(n) for n, op in _CIGAR.findall(f[5])
                   if op in _REF_OPS)
        return f[2], start, start + span, bool(flag & 0x10), int(f[4])
    return None


def _paf_primary(text: str):
    """primary() of PAF lines: target name (column 6), strand (5), start
    and end (8-9, already 0-based and end-exclusive) and MAPQ (12) of the
    first line tagged tp:A:P.  An unmapped read's line (--paf-no-hit)
    carries no tp tag."""
    for line in text.splitlines():
        f = line.split("\t")
        if "tp:A:P" in f[12:]:
            return f[5], int(f[7]), int(f[8]), f[4] == "-", int(f[11])
    return None


def off(name: str, text: str, sam: bool = True) -> int:
    """1 where the read's primary record (SAM, or PAF where `sam` is
    false) is missing, unmapped, or placed at MAPQ 1 or more off the
    read's origin; else 0."""
    rec = primary(text, sam)
    if rec is None:
        return 1
    chrom, start, end, rev, mapq = rec
    if mapq == 0:
        return 0
    o_chrom, o_start, o_end, o_rev = origin(name)
    return int(chrom != o_chrom or rev != o_rev or end <= o_start
               or start >= o_end)
