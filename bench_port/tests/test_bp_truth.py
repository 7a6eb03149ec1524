"""The records held to each read's origin (reference/truth.py)."""

import pytest

from bench_port.tests import bp_tiny  # noqa: F401  (puts the root on the path)
from bench_port.reference import truth

NAME = "chr2_7_1000_500-"


def _sam(flag, chrom="chr2", pos=1001, mapq=60, cigar="300M10D200M"):
    return "\t".join(["r", str(flag), chrom, str(pos), str(mapq), cigar,
                      "*", "0", "0", "ACGT", "*"])


def test_origin():
    assert truth.origin(NAME) == ("chr2", 1000, 1500, True)
    assert truth.origin("chr1_0_5_20+") == ("chr1", 5, 25, False)


def test_sam_primary_skips_secondary_and_supplementary():
    text = "\n".join([_sam(0x110, "chr1"), _sam(0x810, "chr3"),
                      _sam(0x10)]) + "\n"
    assert truth.primary(text) == ("chr2", 1000, 1510, True, 60)
    assert truth.off(NAME, text) == 0


@pytest.mark.parametrize("text", [
    _sam(0x10, chrom="chr1"),                     # another chromosome
    _sam(0x0),                                    # the other strand
    _sam(0x10, pos=1600),                         # no overlap
    _sam(0x4, chrom="*", pos=0, mapq=0, cigar="*"),   # unmapped
    "",                                           # no record
])
def test_confident_wrong_answers_are_off(text):
    assert truth.off(NAME, text) == 1


def test_mapq_zero_claims_no_position():
    assert truth.off(NAME, _sam(0x10, chrom="chr1", mapq=0)) == 0


def _paf(strand="-", chrom="chr2", start=1000, end=1500, mapq=60, tp="P"):
    return "\t".join(["r", "510", "0", "510", strand, chrom, "500000",
                      str(start), str(end), "490", "510", str(mapq),
                      "NM:i:20", f"tp:A:{tp}", "cm:i:40"])


def test_paf_primary_is_the_first_line_tagged_p():
    text = "\n".join([_paf(chrom="chr1", tp="S"), _paf(start=1100),
                      _paf(chrom="chr3")]) + "\n"
    assert truth.primary(text, sam=False) == ("chr2", 1100, 1500, True, 60)
    assert truth.off(NAME, text, sam=False) == 0


@pytest.mark.parametrize("text", [
    _paf(chrom="chr1"),                           # another chromosome
    _paf(strand="+"),                             # the other strand
    _paf(start=1500, end=1900),                   # no overlap
    _paf(chrom="chr1", tp="S"),                   # no primary line
    "r\t510\t0\t0\t*\t*\t0\t0\t0\t0\t0\t0\trl:i:0",   # unmapped
    "",                                           # no line at all
])
def test_paf_confident_wrong_answers_are_off(text):
    assert truth.off(NAME, text, sam=False) == 1


def test_paf_mapq_zero_claims_no_position():
    assert truth.off(NAME, _paf(chrom="chr1", mapq=0), sam=False) == 0
