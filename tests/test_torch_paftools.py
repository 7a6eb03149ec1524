"""The port's paftools and mmphase against the JAX package's, byte for byte.

Each case of tests/test_paftools.py (mmphase's two modes among them),
and `stat` / `sam2paf` on golden outputs in the repo, runs both
packages' `main` on the same files: the return codes, stdout and stderr
must be equal.  The inputs that a mapper writes (the PAF and SAM of a
contig with planted variants against its reference) come from the JAX
package's CLI, as in tests/test_paftools.py.
"""

import contextlib
import importlib
import io

import pytest

from tests.conftest import golden_path
from tests.test_paftools import PAF, _mk_variant_pair

STAT_PAF = ("q1\t1000\t0\t1000\t+\tchr1\t10000\t0\t1010\t980\t1010\t60\t"
            "NM:i:30\tnn:i:0\ttp:A:P\tcm:i:50\ts1:i:700\ts2:i:0\t"
            "cg:Z:500M10D490M10I\n")


def _paf_line(q, qs, qe, strand, ctg, ts, te):
    return (f"{q}\t10000000\t{qs}\t{qe}\t{strand}\t{ctg}\t50000000"
            f"\t{ts}\t{te}\t{qe-qs}\t{qe-qs}\t60\n")


# the input files of tests/test_paftools.py's cases, by name
TEXTS = {
    "sim.paf": PAF,
    "stat.paf": STAT_PAF,
    "lift.bed": "ctg\t19990\t20010\nctg\t29990\t30010\nctg\t39990\t40010\n",
    "g.gtf": ('chr1\tx\texon\t101\t200\t.\t+\t.\ttranscript_id "t1";\n'
              'chr1\tx\texon\t301\t400\t.\t+\t.\ttranscript_id "t1";\n'),
    "junc.sam": ("r1\t0\tchr1\t101\t60\t100M100N100M\t*\t0\t0\t*\t*\n"
                 "r2\t0\tchr1\t101\t60\t100M90N100M\t*\t0\t0\t*\t*\n"
                 "r3\t0\tchr1\t101\t60\t200M\t*\t0\t0\t*\t*\n"),
    "reg.bed": "chr1\t10\t50\nchr1\t40\t80\n",
    "tgt.bed": "chr1\t0\t100\nchr1\t200\t300\n",
    "v.vcf": ("##x\n"
              "chr1\t5\t.\tA\tG\t.\t.\t.\n"
              "chr1\t9\t.\tAT\tA\t.\t.\t.\n"
              "chr1\t12\t.\tC\tCAGG\t.\t.\t.\n"
              "chr1\t20\t.\tA\tT,C\t.\t.\t.\n"),
    "b.paf": ("q1\t10000\t0\t9000\t+\tc1\t50000\t100\t9100\t8000"
              "\t9000\t60\ttp:A:P\n"
              "q2\t10000\t0\t9000\t+\tc1\t50000\t20000\t29000"
              "\t8000\t9000\t60\ttp:A:P\n"),
    "t.paf": ("q1\t10000\t0\t9000\t+\tc1\t50000\t120\t9120\t8000"
              "\t9000\t60\ttp:A:P\n"
              "q2\t10000\t0\t9000\t+\tc2\t50000\t100\t9100\t8000"
              "\t9000\t60\ttp:A:P\n"),
    "misjoin.paf": (
        _paf_line("A", 0, 2000000, "+", "chr1", 0, 2000000)
        + _paf_line("A", 2000000, 4000000, "+", "chr2", 0, 2000000)
        + _paf_line("B", 0, 2000000, "+", "chr3", 0, 2000000)
        + _paf_line("B", 2000000, 4000000, "+", "chr3", 8000000, 10000000)
        + _paf_line("C", 0, 2000000, "+", "chr4", 0, 2000000)
        + _paf_line("C", 2000000, 4000000, "-", "chr4", 2000000, 4000000)
        + _paf_line("C", 4000000, 6000000, "+", "chr4", 4000000, 6000000)),
    "toref.paf": (
        "r1\t9500\t0\t9300\t+\tc1\t50000\t0\t9000\t9000\t9000\t60"
        "\ttp:A:P\n"
        "r2\t9500\t0\t9300\t+\tc1\t50000\t5000\t14000\t9000\t9000\t60"
        "\ttp:A:P\n"
        "r3\t9500\t0\t9300\t+\tc1\t50000\t30000\t39000\t9000\t9000\t60"
        "\ttp:A:P\n"),
    "ovl.paf": ("r1\t9500\t5000\t9300\t+\tr2\t9500\t0\t4000\t4000"
                "\t4000\t0\n"),
    "t.gtf": (
        'chr1\tH\texon\t101\t200\t.\t+\t.\tgene_id "G1"; transcript_id '
        '"T1"; transcript_type "protein_coding"; gene_name "GENE1"; '
        'transcript_name "T1-201";\n'
        'chr1\tH\tCDS\t121\t180\t.\t+\t.\tgene_id "G1"; transcript_id '
        '"T1"; transcript_type "protein_coding"; gene_name "GENE1"; '
        'transcript_name "T1-201";\n'
        'chr1\tH\texon\t301\t400\t.\t+\t.\tgene_id "G1"; transcript_id '
        '"T1"; transcript_type "protein_coding"; gene_name "GENE1"; '
        'transcript_name "T1-201";\n'),
    "s.sam": "r1\t0\tchr1\t101\t60\t50M100N50M\t*\t0\t0\tACGT\t*\n",
    "s.paf": ("r1\t100\t0\t100\t+\tchr1\t5000\t100\t300\t100\t200"
              "\t60\ts2:i:0\tcg:Z:50M100N50M\n"),
    "d.delta": ("/r /q\nNUCMER\n>ref qry 1000 900\n"
                "1 500 1 501 2 2 0\n-200\n0\n"),
    "m.sam": ("simulated.1\t65\tchr1\t101\t60\t4M\t*\t0\t0\tACGT\tFFFF"
              "\tXE:i:1\tXS:i:0\tXI:i:0\n"
              "simulated.1\t145\tchr1\t401\t60\t4M\t*\t0\t0\tACGT\tFFFF"
              "\tXE:i:2\tXS:i:1\tXI:i:0\n"),
    "r.fai": "chrA\t1000\nchrB\t2000\n",
    "p.maf": ("a\n"
              "s ref 100 8 + 1000 ACGTACGT\n"
              "s S2_1 0 8 - 8 ACG-TACGT\n"),
    "p.vcf": (
        "##fileformat=VCFv4.2\n"
        "##source=test\n"
        "##contig=<ID=chr1,length=1000>\n"
        "##contig=<ID=chrZ,length=5>\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tH1\tH2\n"
        "chr1\t100\t.\tA\tG\t.\t.\t.\tGT:AD\t1/1:0,9\t0/0:5,1\n"
        "chr1\t200\t.\tA\tAT\t.\t.\t.\tGT:AD\t./.:2,2\t1/1:0,7\n"),
    "sel.vcf": ("##x\n"
                "chr1\t10\t.\tA\tG\t.\t.\t.\n"
                "chr1\t20\t.\tA\tATTTT\t.\t.\t.\n"
                "chr1\t30\t.\tACC\tA\t.\t.\tSVLEN=-2\n"),
    "asm.fai": "chr1\t1000000\n",
    "asm.paf": (
        "ctg1\t500000\t0\t200000\t+\tchr1\t1000000\t0\t200000\t199000"
        "\t200000\t60\ttp:A:P\tNM:i:1000\tcg:Z:200000M\n"
        "ctg1\t500000\t220000\t500000\t+\tchr1\t1000000\t230000\t510000"
        "\t278000\t280000\t60\ttp:A:P\tNM:i:2000\tcg:Z:280000M\n"
        "ctg2\t300000\t0\t300000\t+\tchr1\t1000000\t600000\t900000"
        "\t299000\t300000\t60\ttp:A:P\tNM:i:1000\tcg:Z:300000M\n"),
    "gref.paf": (
        "g1\t2000\t0\t2000\t+\tchr1\t1000000\t1000\t3100\t1990\t2000"
        "\t60\n"
        "g2\t1500\t0\t1500\t+\tchr1\t1000000\t5000\t6600\t1495\t1500"
        "\t60\n"),
    "gasm.paf": (
        "g1\t2000\t0\t2000\t+\tctg1\t500000\t1000\t3100\t1990\t2000"
        "\t60\n"
        "g2\t1500\t0\t700\t+\tctg1\t500000\t5000\t5750\t698\t700\t60\n"),
    "base.vcf": ("##x\n"
                 "chr1\t1000\t.\tA\t" + "A" + "T" * 100 + "\t30\t.\t.\n"
                 "chr1\t5000\t.\t" + "A" * 81 + "\tA\t30\t.\t.\n"),
    "call.vcf": ("##x\n"
                 "chr1\t1050\t.\tA\t" + "A" + "T" * 95 + "\t30\t.\t.\n"),
    "ph.paf": (
        "q1\t10000\t0\t10000\t+\tutgA\t20000\t100\t10100\t9990\t10000"
        "\t60\tcs:Z::5000*ac:4999\n"
        "q1\t10000\t0\t10000\t+\tutgB\t20000\t200\t10200\t9500\t10000"
        "\t60\tcs:Z::10000\n"),
    "ec.paf": ("q1\t10000\t0\t10000\t+\tutgB\t20000\t200\t10200\t9990\t10000"
               "\t60\tcs:Z::5000*ga:4999\n"),
    "q1.fa": ">q1\n" + "A" * 10000 + "\n",
}

# the mapper's outputs on the planted-variant pair (the JAX package's
# CLI, as tests/test_paftools.py::_map): name -> flags
MAPPED = {"cs.paf": ["-c", "--cs"], "c.paf": ["-c"],
          "md.sam": ["-a", "--MD"], "cslong.paf": ["-c", "--cs=long"]}

# (tool, argv with {file} names), by case id
CASES = {
    "mapeval": ("paftools", ["mapeval", "{sim.paf}"]),
    "stat": ("paftools", ["stat", "{stat.paf}"]),
    "call_text": ("paftools", ["call", "{cs.paf}"]),
    "call_vcf": ("paftools", ["call", "-f", "{ref.fa}", "{cs.paf}"]),
    "liftover": ("paftools", ["liftover", "-l", "1000", "{c.paf}",
                              "{lift.bed}"]),
    "sam2paf": ("paftools", ["sam2paf", "{md.sam}"]),
    "view_maf": ("paftools", ["view", "-f", "maf", "{cslong.paf}"]),
    "view_lastz": ("paftools", ["view", "-f", "lastz-cigar",
                                "{cslong.paf}"]),
    "view_aln": ("paftools", ["view", "-l", "60", "{cslong.paf}"]),
    "junceval": ("paftools", ["junceval", "{g.gtf}", "{junc.sam}"]),
    "junceval_p": ("paftools", ["junceval", "-p", "{g.gtf}", "{junc.sam}"]),
    "junceval_l": ("paftools", ["junceval", "-l", "10", "{g.gtf}",
                                "{junc.sam}"]),
    "bedcov": ("paftools", ["bedcov", "{reg.bed}", "{tgt.bed}"]),
    "bedcov_p": ("paftools", ["bedcov", "-p", "{reg.bed}", "{tgt.bed}"]),
    "vcfstat": ("paftools", ["vcfstat", "{v.vcf}"]),
    "pafcmp": ("paftools", ["pafcmp", "{b.paf}", "{t.paf}"]),
    "misjoin": ("paftools", ["misjoin", "{misjoin.paf}"]),
    "ov_eval": ("paftools", ["ov-eval", "{toref.paf}", "{ovl.paf}"]),
    "version": ("paftools", ["version"]),
    "gff2bed": ("paftools", ["gff2bed", "{t.gtf}"]),
    "gff2bed_j": ("paftools", ["gff2bed", "-j", "{t.gtf}"]),
    "gff2bed_s": ("paftools", ["gff2bed", "-s", "{t.gtf}"]),
    "splice2bed_sam": ("paftools", ["splice2bed", "{s.sam}"]),
    "splice2bed_paf": ("paftools", ["splice2bed", "{s.paf}"]),
    "delta2paf": ("paftools", ["delta2paf", "{d.delta}"]),
    "mason2fq": ("paftools", ["mason2fq", "{m.sam}"]),
    "pbsim2fq": ("paftools", ["pbsim2fq", "{r.fai}", "{p.maf}"]),
    "vcfpair": ("paftools", ["vcfpair", "{p.vcf}"]),
    "vcfsel": ("paftools", ["vcfsel", "-l", "2", "{sel.vcf}"]),
    "asmstat": ("paftools", ["asmstat", "{asm.fai}", "{asm.paf}"]),
    "asmgene": ("paftools", ["asmgene", "{gref.paf}", "{gasm.paf}"]),
    "sveval": ("paftools", ["sveval", "{base.vcf}", "{call.vcf}"]),
    "mmphase_binning": ("mmphase", ["{ph.paf}"]),
    "mmphase_ec": ("mmphase", ["{ec.paf}", "{q1.fa}"]),
    "stat_sim200_cs": ("paftools", [
        "stat", golden_path("sim200.skipinf.cs.paf.gz")]),
    "stat_splice40": ("paftools", [
        "stat", golden_path("splice40.skipinf.c.paf.gz")]),
    "sam2paf_pe300": ("paftools", [
        "sam2paf", golden_path("pe300.sr.skipinf.sam.gz")]),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every input file of CASES, by name."""
    from mm2_gb_tpu.cli import main as jax_main
    d = tmp_path_factory.mktemp("paftools")
    out = {}
    for name, text in TEXTS.items():
        (d / name).write_text(text)
        out[name] = str(d / name)
    out["ref.fa"], ctg = _mk_variant_pair(d)
    for name, flags in MAPPED.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            assert jax_main(["--max-chain-skip=2147483647", *flags,
                             out["ref.fa"], ctg]) == 0
        (d / name).write_text(buf.getvalue())
        out[name] = str(d / name)
    return out


def _main(pkg, tool, argv):
    """(rc, stdout, stderr) of a package's tool main on argv."""
    mod = importlib.import_module(f"{pkg}.tools.{tool}")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(list(argv))
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("case", list(CASES))
def test_tool_matches_the_jax_package(case, files):
    tool, argv = CASES[case]
    argv = [files[a[1:-1]] if a.startswith("{") else a for a in argv]
    port = _main("mm2_gb_tpu_torch", tool, argv)
    ref = _main("mm2_gb_tpu", tool, argv)
    assert port == ref
    assert port[0] in (0, None) and (port[1] or port[2])
