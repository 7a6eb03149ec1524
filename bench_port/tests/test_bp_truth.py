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
