"""Randomized differential campaign of the port: random read profiles x
random flag subsets, the port's `--gpu-chain` run path against the
port's host route, byte-diff everything.

    python -m mm2_gb_tpu_torch.tools.fuzz_diff N SEED0 [--work DIR]
        [--ref-cmd CMD] [--device cuda|cpu] [--kind ava|asm]

Seeds SEED0 .. SEED0+N-1.  The workload generators are a copy of the
repo's tools/fuzz_diff.py (the same `random.Random(seed)` draws, so a
seed means the same reads and flags in both tools), with the files under
a seed-private directory of the work directory (default build/fuzz/<seed>)
instead of /tmp, and three more kinds:

  genomic  - random/repeat-rich reference, long reads with subs/indels and
             occasionally planted inversions; broad flag pool.
  splice   - exon/intron genome with GT..AG introns, spliced cDNA reads;
             splice presets, -u strand modes, optional --junc-bed.
  pe       - short paired-end reads in FR orientation; -x sr.
  long     - (not in the original) a 1-4 Mbp reference and 30-100 kb
             reads, the bench flowcell's lengths, about half of them with a
             planted insertion of 3-61 kb, which the long join bridges with
             a gap fill of the insert's bases beside a short target; -c at
             the default -r and at -r 500,80000.  Its own weight in the kind
             draw leaves the other kinds' draws as the original's but for
             which kind a seed draws.
  ava      - (not in the original, and never drawn: `--kind ava` asks for
             it) all-vs-all overlap of a read set against itself, the
             reads drawn from a random or repeat-rich reference at 3-8x
             coverage under names in shuffled order; -x ava-ont (chained
             on the card) or -x ava-pb (HPC: chained on the host, as in
             the JAX package), with or without -c.  The genomic kind's
             -x ava-ont maps reads named q{i} to a reference named fr or
             ctg{k}, and NO_DUAL drops every hit whose query name sorts
             after its target name, so those seeds compare two empty
             outputs.
  asm      - (not in the original, and never drawn: `--kind asm` asks for
             it) assembly to reference: one to three random chromosomes,
             and contigs made from them with deletions and insertions of
             50 bases to 8 kb every 20-80 kb, now and then an inversion,
             and 0.05-2% substitutions and up to 0.5% indels, cut into
             contigs of 50-400 kb, half of them reverse-complemented;
             -x asm5, asm10 or asm20 with -c, or -c --cs.  The asm
             presets chain by RMQ on the host; their gap fills, at a
             band of 150,001, run on the card.

Each seed, of every kind, also draws -t from {1, 4, 8} after its
workload.

The device side runs in this process through `cli.parse_args` and
`cli._run(args, argv, io, mo, device)`: the drawn flags without
--tpu-chain/--tpu-align, plus --gpu-chain, and --gpu-align whenever they
align (-c, -a, --cs, --MD, --eqx, -Y).  `device` is the CUDA card unless
the caller asks for the CPU (the kernels' plain twins).  The reference side
is `python -m mm2_gb_tpu_torch --device cpu` (REF_CMD: the port's host
route, a verbatim copy of the JAX package's host path, whose bytes the
tests hold to the JAX package's) in a subprocess from the repository's
root, with the same flags without any --gpu-*/--tpu-* and
--max-chain-skip=2147483647, or --ref-cmd (such as a minimap2 binary, or
the JAX package's host path on a machine that has it); LD_PRELOAD,
ASAN_OPTIONS and MM2TPU_NATIVE_LIB are not passed on to it.  Up to
REF_AHEAD reference runs go ahead of the device side.

A seed matches when both sides exit 0 and their stdout is equal byte for
byte, @PG lines aside, and, for an ava seed, no PAF line breaks the
overlap filters (ava_order_faults); a seed of a kind no seed draws (ava,
asm) fails when both outputs are empty.  Each seed prints one `ok`/`FAIL`
line with its kind, flags and -t; a FAIL adds both return codes, the
first differing line and both line counts, and keeps the seed's files.  Per seed the
port's launch counters say which kernels ran, and the `-v 3` lines the
host-routed counts; the summary prints per kernel the launches over the
campaign and the launch classes reached, and the seeds whose two outputs
were both empty by kind and flag set (a match that compared nothing).
The exit code is 1 on any FAIL.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import math
import os
import random
import re
import shlex
import shutil
import subprocess
import sys
import time
import traceback
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import torch

from mm2_gb_tpu_torch import cli
from mm2_gb_tpu_torch.ops import chain_gpu, ksw2_gpu, ksw2s_gpu
from mm2_gb_tpu_torch.utils import opts as O

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORK = os.path.join(REPO, "build", "fuzz")
SKIP_INF = "--max-chain-skip=2147483647"
REF_CMD = [sys.executable, "-m", "mm2_gb_tpu_torch", "--device", "cpu"]
KINDS = ("genomic", "splice", "pe", "long")
KIND_WEIGHTS = (0.6, 0.25, 0.15, 0.05)
# kinds a seed never draws: make_workload's kind= asks for one
OTHER_KINDS = ("ava", "asm")
THREADS = (1, 4, 8)
ALIGN_FLAGS = ("-c", "-a", "--MD", "--eqx", "-Y")
REF_TIMEOUT = 900
REF_AHEAD = 2   # reference subprocesses in flight beside the device side
# not passed on to the reference side (a sanitizer build of the port)
REF_ENV_DROP = ("LD_PRELOAD", "ASAN_OPTIONS", "MM2TPU_NATIVE_LIB")
B = "ACGT"


def rnd_seq(n, rng):
    return "".join(rng.choice(B) for _ in range(n))


def mutate(s, rng, sub, ind):
    out = []
    for c in s:
        r = rng.random()
        if r < sub:
            out.append(rng.choice(B))
        elif r < sub + ind / 2:
            pass
        elif r < sub + ind:
            out.append(c)
            out.append(rng.choice(B))
        else:
            out.append(c)
    return "".join(out)


def write_fa(path, recs):
    with open(path, "w") as f:
        for name, s in recs:
            f.write(f">{name}\n")
            for i in range(0, len(s), 80):
                f.write(s[i:i + 80] + "\n")


def _sc(n, scale, least=1):
    """n at the generator's scale (n itself at scale 1)."""
    return n if scale == 1 else max(least, int(n * scale))


def make_genomic(rng, work, tag, scale=1):
    S = lambda n, least=1: _sc(n, scale, least)   # noqa: E731
    style = rng.randrange(5)
    ref_len = rng.randrange(S(20_000, 1000), S(400_000, 2000))
    if style == 3:  # repeat-rich reference
        parts = []
        unit = rnd_seq(rng.randrange(50, 2000), rng)
        while sum(map(len, parts)) < ref_len:
            parts.append(unit if rng.random() < 0.5 else rnd_seq(1000, rng))
        ref = "".join(parts)[:ref_len]
    else:
        ref = rnd_seq(ref_len, rng)
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for i in range(rng.randrange(S(10, 3), S(60, 6))):
        if rng.random() < 0.1:  # unrelated read
            reads.append((f"q{i}", rnd_seq(rng.randrange(100, 3000), rng)))
            continue
        ln = rng.randrange(100, min(S(30_000, 200), ref_len))
        st = rng.randrange(0, ref_len - ln)
        s = mutate(ref[st:st + ln], rng,
                   rng.uniform(0, 0.12), rng.uniform(0, 0.03))
        if rng.random() < 0.05:  # planted inversion
            m = len(s) // 2
            w = rng.randrange(100, max(101, len(s) // 3))
            seg = s[m:m + w]
            s = s[:m] + seg.translate(comp)[::-1] + s[m + w:]
        if rng.random() < 0.5:
            s = s.translate(comp)[::-1]
        reads.append((f"q{i}", s))
    fz = os.path.join(work, f"fz_{tag}")
    rfa, qfa = f"{fz}_r.fa", f"{fz}_q.fa"
    if rng.random() < 0.3:  # multi-contig reference (exercises rid paths)
        n_ctg = rng.randrange(2, 5)
        edge = S(5000, 100)
        cuts = sorted(rng.sample(range(edge, max(edge + 1, ref_len - edge)),
                                 n_ctg - 1))
        bounds = [0] + cuts + [ref_len]
        write_fa(rfa, [(f"ctg{k}", ref[bounds[k]:bounds[k + 1]])
                       for k in range(n_ctg)])
        multi_ctg = True
    else:
        write_fa(rfa, [("fr", ref)])
        multi_ctg = False
    write_fa(qfa, reads)
    flag_pool = [
        [], ["-c"], ["-c", "--cs"], ["-a"], ["-c", "--eqx"],
        ["-x", "map-pb", "-c"], ["-x", "map-hifi", "-c"],
        ["-x", "asm20", "-c"], ["-x", "ava-ont"], ["-N", "10", "-c"],
        ["-p", "0.6", "-c"], ["-r", "100", "-c"], ["-k", "17", "-c"],
        ["-w", "5", "-c"], ["--rmq=yes", "-c"], ["-T", "20", "-c"],
        ["-A", "1", "-B", "9", "-O", "16,41", "-E", "2,1", "-c"],
        ["--for-only", "-c"], ["-g", "1000", "-c"], ["-z", "200", "-c"],
        ["--qstrand", "-c"], ["--qstrand", "-c", "--cs"],
        ["--cs=long", "-c"], ["-a", "--MD"], ["-a", "--eqx"],
        ["--tpu-chain", "-c", "--cs"], ["--tpu-chain", "--tpu-align", "-c"],
        # max_occ > mid_occ exercises the post-device re-chain branch
        ["--tpu-chain", "-f", "0.0002,5000", "-c"],
        ["--tpu-chain", "-f", "0.001,50", "-c"],
        ["-f", "0.0002,5000", "-c"],
        # round-1 flag-surface completion
        ["-P", "-c"], ["-D", "-c"], ["--end-bonus", "12", "-c"],
        ["--max-qlen", "50k", "-c"], ["--chain-skip-scale", "0.5", "-c"],
        ["--chain-gap-scale", "1.5", "-c"], ["--mask-len", "500", "-c"],
        ["--max-clip-ratio", "0.2", "-c"], ["--no-end-flt", "-c"],
        ["--hard-mask-level", "-c"], ["--no-hash-name", "-c"],
        ["--min-dp-len", "500", "-c"], ["--score-N", "0", "-c"],
        ["-f", "30", "-c"], ["-e", "200", "-c"], ["--q-occ-frac", "0.05"],
        ["--no-long-join", "-c"], ["-M", "0.3", "-c"], ["-N", "0", "-c"],
        ["--cap-sw-mem", "1m", "-c"], ["-a", "-Y"], ["-a", "-Q"],
        ["--heap-sort=yes", "-c"], ["--dual=no"], ["-g", "2k", "-c"],
        # round-3 additions: HPC sketching, large k/w, secondary modes
        ["-H"], ["-H", "-c"], ["-H", "-x", "map-pb", "-c"],
        ["-k", "19", "-w", "19", "-c"], ["-k", "28", "-w", "28"],
        ["--secondary", "no", "-c"], ["-p", "0.9", "-N", "2", "-c"],
    ]
    part = f"{S(100)}k"
    if multi_ctg:  # multi-part index build + two-phase merge
        flag_pool += [["-I", part, "--split-prefix", f"{fz}_sp", "-c"]] * 4
        flag_pool += [["-I", part, "--tpu-chain", "-c"],
                      ["-I", part, "--split-prefix", f"{fz}_tsp",
                       "--tpu-chain", "-c"]]
    if rng.random() < 0.15:
        # second query file, NO frag mode: per-file sequential mapping
        # (main.c:451-455), and with --split-prefix the reference's
        # tmp-truncation + interleaved-merge quirk (splitmerge.py)
        q2 = f"{fz}_q2.fa"
        write_fa(q2, [(f"r{i}", s) for i, (_n, s) in
                      enumerate(reads[:rng.randrange(3, len(reads) + 1)])])
        pool2 = [[], ["-c"], ["-a"],
                 ["--split-prefix", f"{fz}_m2", "-c"],
                 ["--split-prefix", f"{fz}_m2"],
                 ["-I", part, "--split-prefix", f"{fz}_m2", "-c"]]
        return rng.choice(pool2), [rfa, qfa, q2]
    return rng.choice(flag_pool), [rfa, qfa]


def make_splice(rng, work, tag, scale=1):
    S = lambda n, least=1: _sc(n, scale, least)   # noqa: E731
    comp = str.maketrans("ACGT", "TGCA")
    glen = rng.randrange(S(40_000, 4000), S(200_000, 8000))
    genome = rnd_seq(glen, rng)
    reads = []
    for i in range(rng.randrange(S(8, 2), S(25, 3))):
        n_ex = rng.randrange(2, 7)
        pos = rng.randrange(0, glen - S(25_000, 2500))
        exons = []
        for _ in range(n_ex):
            elen = rng.randrange(60, 600)
            if pos + elen >= glen - S(12_000, 1200):
                break
            exons.append((pos, pos + elen))
            intron = rng.randrange(80, S(8_000, 200))
            pos += elen + intron
        if len(exons) < 2:
            continue
        # canonical splice sites help the junction model; plant GT..AG
        g = list(genome)
        for (s0, e0), (s1, _) in zip(exons[:-1], exons[1:]):
            g[e0], g[e0 + 1] = "G", "T"
            g[s1 - 2], g[s1 - 1] = "A", "G"
        genome = "".join(g)
        cdna = "".join(genome[s0:e0] for s0, e0 in exons)
        cdna = mutate(cdna, rng, rng.uniform(0, 0.08), rng.uniform(0, 0.02))
        if rng.random() < 0.5:
            cdna = cdna.translate(comp)[::-1]
        reads.append((f"t{i}", cdna))
    fz = os.path.join(work, f"fz_{tag}")
    rfa, qfa = f"{fz}_r.fa", f"{fz}_q.fa"
    write_fa(rfa, [("g", genome)])
    write_fa(qfa, reads)
    flag_pool = [
        ["-x", "splice"], ["-x", "splice", "-c"],
        ["-x", "splice", "-c", "--cs"], ["-x", "splice", "-a"],
        ["-x", "splice", "-u", "f", "-c"], ["-x", "splice", "-u", "b", "-c"],
        ["-x", "splice", "-C", "5", "-c"], ["-x", "splice:hq", "-c"],
        ["-x", "splice", "-G", "10000", "-c"],
        ["-x", "splice", "--splice-flank=no", "-c"],
        ["-x", "splice", "--max-intron-len", "20k", "-c"],
        ["-x", "splice", "--cost-non-gt-ag", "4", "-c"],
        ["--splice", "-u", "b", "-c"],
        # device splice: is_cdna chain kernel + exts2 device fills
        ["-x", "splice", "-c", "--tpu-chain"],
        ["-x", "splice", "-c", "--tpu-chain", "--tpu-align"],
        ["-x", "splice", "-u", "b", "-c", "--tpu-chain", "--tpu-align"],
        # splice through the split-prefix dump+merge
        ["-x", "splice", "-c", "--split-prefix", f"{fz}_ssp"],
        ["-x", "splice", "-a", "--split-prefix", f"{fz}_ssp"],
    ]
    return rng.choice(flag_pool), [rfa, qfa]


def make_pe(rng, work, tag, scale=1):
    S = lambda n, least=1: _sc(n, scale, least)   # noqa: E731
    comp = str.maketrans("ACGT", "TGCA")
    ref_len = rng.randrange(S(50_000, 2000), S(300_000, 4000))
    ref = rnd_seq(ref_len, rng)
    r1, r2 = [], []
    rl = rng.randrange(70, 151)
    for i in range(rng.randrange(S(40, 4), S(200, 8))):
        frag = rng.randrange(2 * rl, 700)
        st = rng.randrange(0, ref_len - frag)
        fwd = ref[st:st + rl]
        rev = ref[st + frag - rl:st + frag].translate(comp)[::-1]
        fwd = mutate(fwd, rng, rng.uniform(0, 0.02), rng.uniform(0, 0.002))
        rev = mutate(rev, rng, rng.uniform(0, 0.02), rng.uniform(0, 0.002))
        r1.append((f"p{i}", fwd))
        r2.append((f"p{i}", rev))
    fz = os.path.join(work, f"fz_{tag}")
    rfa = f"{fz}_r.fa"
    q1, q2 = f"{fz}_1.fa", f"{fz}_2.fa"
    write_fa(rfa, [("pr", ref)])
    write_fa(q1, r1)
    write_fa(q2, r2)
    flag_pool = [
        ["-x", "sr"], ["-x", "sr", "-a"], ["-x", "sr", "-c"],
        ["-x", "sr", "-a", "--secondary", "no"],
        ["-x", "sr", "--no-pairing"], ["-x", "sr", "-a", "-Q"],
        ["--sr", "--frag", "yes"],
        # paired-end through the split-prefix dump+merge (mm_pair gets
        # the dumped frag_gap, map.c:1264)
        ["-x", "sr", "-a", "--split-prefix", f"{fz}_psp"],
        ["-x", "sr", "-c", "--split-prefix", f"{fz}_psp"],
    ]
    return rng.choice(flag_pool), [rfa, q1, q2]


def make_long(rng, work, tag, scale=1):
    """Reads of the bench flowcell's lengths against a reference of a few
    Mbp; about half carry a planted insertion of random bases in their
    middle (the input of chip_smoke.insertion_reads, at random lengths)."""
    S = lambda n, least=1: _sc(n, scale, least)   # noqa: E731
    comp = str.maketrans("ACGT", "TGCA")
    ref_len = rng.randrange(S(1_000_000, 20_000), S(4_000_000, 40_000))
    ref = "".join(rng.choices(B, k=ref_len))
    reads = []
    for i in range(rng.randrange(4, 13)):
        ln = rng.randrange(S(30_000, 500), S(100_000, 1000))
        st = rng.randrange(0, ref_len - ln)
        s = mutate(ref[st:st + ln], rng,
                   rng.uniform(0.01, 0.06), rng.uniform(0, 0.03))
        if rng.random() < 0.5:
            m = len(s) // 2
            ins = rng.randrange(S(3_000, 60), S(61_000, 120))
            s = s[:m] + "".join(rng.choices(B, k=ins)) + s[m:]
        if rng.random() < 0.5:
            s = s.translate(comp)[::-1]
        reads.append((f"l{i}", s))
    fz = os.path.join(work, f"fz_{tag}")
    rfa, qfa = f"{fz}_r.fa", f"{fz}_q.fa"
    write_fa(rfa, [("lr", ref)])
    write_fa(qfa, reads)
    return rng.choice([["-c"], ["-r", "500,80000", "-c"]]), [rfa, qfa]


def make_ava(rng, work, tag, scale=1):
    """All-vs-all overlap: reads of a random or repeat-rich reference (at
    3-8x coverage, 10% of them unrelated, half reverse-complemented) as
    both the target and the query file, named s<k> with k a random
    permutation of the read order, so that the name order (which the
    overlap filters NO_DUAL and NO_DIAG read) is not the file order."""
    S = lambda n, least=1: _sc(n, scale, least)   # noqa: E731
    comp = str.maketrans("ACGT", "TGCA")
    n = rng.randrange(S(12, 6), S(40, 10))
    lens = [rng.randrange(S(2_000, 300), S(15_000, 1_500)) for _ in range(n)]
    ref_len = max(max(lens) + 1, int(sum(lens) / rng.uniform(3, 8)))
    if rng.random() < 0.3:   # repeat-rich, as make_genomic's style 3
        parts = []
        unit = rnd_seq(rng.randrange(50, 2000), rng)
        while sum(map(len, parts)) < ref_len:
            parts.append(unit if rng.random() < 0.5 else rnd_seq(1000, rng))
        ref = "".join(parts)[:ref_len]
    else:
        ref = rnd_seq(ref_len, rng)
    sub, ind = rng.uniform(0, 0.08), rng.uniform(0, 0.04)
    names = rng.sample(range(10 * n), n)
    reads = []
    for k, ln in zip(names, lens):
        if rng.random() < 0.1:   # unrelated read
            s = rnd_seq(ln, rng)
        else:
            st = rng.randrange(0, ref_len - ln)
            s = mutate(ref[st:st + ln], rng, sub, ind)
        if rng.random() < 0.5:
            s = s.translate(comp)[::-1]
        reads.append((f"s{k}", s))
    qfa = os.path.join(work, f"fz_{tag}_reads.fa")
    write_fa(qfa, reads)
    # -x ava-ont chains on the card, -x ava-pb on the host: 4 to 2
    flag_pool = [["-x", "ava-ont"], ["-x", "ava-ont"], ["-x", "ava-ont", "-c"],
                 ["-x", "ava-ont", "-c", "--cs"], ["-x", "ava-pb"],
                 ["-x", "ava-pb", "-c"]]
    return rng.choice(flag_pool), [qfa, qfa]


def make_asm(rng, work, tag, scale=1):
    """Assembly to reference: one to three random chromosomes (named
    chr<k>) as the reference, and each one, with deletions and
    insertions (random bases), one of the two at random, of 50 bases to
    8 kb (log-uniform) every 20-80 kb, an inversion of 1-20 kb half of
    the time, and substitutions and indels at one rate a seed (mutate),
    cut into contigs of 50-400 kb (a shorter tail joins its contig),
    half of them reverse-complemented, as the query."""
    S = lambda n, least=1: _sc(n, scale, least)   # noqa: E731
    comp = str.maketrans("ACGT", "TGCA")
    chroms = ["".join(rng.choices(B, k=rng.randrange(S(100_000, 20_000),
                                                      S(600_000, 40_000))))
              for _ in range(rng.randrange(1, 4))]
    sub, ind = rng.uniform(0.0005, 0.02), rng.uniform(0, 0.005)
    lo, hi = math.log(50), math.log(S(8_000, 800))
    contigs = []
    for chrom in chroms:
        parts, pos = [], 0
        while True:
            nxt = pos + rng.randrange(S(20_000, 2_000), S(80_000, 8_000))
            n = int(math.exp(rng.uniform(lo, hi)))
            if nxt + n >= len(chrom):
                break
            parts.append(chrom[pos:nxt])
            if rng.random() < 0.5:   # a deletion
                pos = nxt + n
            else:                    # an insertion
                parts.append("".join(rng.choices(B, k=n)))
                pos = nxt
        seq = "".join(parts) + chrom[pos:]
        if rng.random() < 0.5:
            n = rng.randrange(S(1_000, 100), S(20_000, 2_000))
            s = rng.randrange(0, len(seq) - n)
            seq = seq[:s] + seq[s:s + n].translate(comp)[::-1] + seq[s + n:]
        seq = mutate(seq, rng, sub, ind)
        start, least = 0, S(50_000, 5_000)
        while start < len(seq):
            n = rng.randrange(least, S(400_000, 40_000))
            if len(seq) - start - n < least:
                n = len(seq) - start
            piece = seq[start:start + n]
            if rng.random() < 0.5:
                piece = piece.translate(comp)[::-1]
            contigs.append((f"tig{len(contigs)}", piece))
            start += n
    fz = os.path.join(work, f"fz_{tag}")
    rfa, qfa = f"{fz}_r.fa", f"{fz}_q.fa"
    write_fa(rfa, [(f"chr{k}", c) for k, c in enumerate(chroms)])
    write_fa(qfa, contigs)
    flags = ["-x", rng.choice(["asm5", "asm10", "asm20"]), "-c"]
    return flags + (["--cs"] if rng.random() < 0.5 else []), [rfa, qfa]


def ava_order_faults(paf: str) -> list:
    """The PAF lines of an all-vs-all run (-x ava-*) that its overlap
    filters forbid: a query name that sorts after its target name (NO_DUAL
    maps each pair of reads once, query name first, map.c:205-227), or a
    read against itself on the diagonal (NO_DIAG drops those anchors; a
    self-hit off the diagonal, from a repeat inside one read, is
    allowed).  Names compare byte for byte, as strcmp does."""
    out = []
    for line in paf.splitlines():
        f = line.split("\t")
        q, t = f[0].encode(), f[5].encode()
        if q > t or q == t and f[2:4] == f[7:9]:
            out.append(line)
    return out


@dataclass
class Workload:
    seed: int
    kind: str
    flags: list
    files: list
    threads: int
    work: str      # the seed's directory


def draw_kind(seed: int) -> str:
    """The kind seed draws (make_workload's first draw)."""
    return random.Random(seed).choices(KINDS, KIND_WEIGHTS)[0]


def make_workload(seed: int, work: str = WORK, scale=1,
                  kind: str | None = None) -> Workload:
    """Seed's workload, written under work/<seed>.  scale < 1 shrinks
    the reference lengths, read lengths and read counts (tests).  kind
    (one of OTHER_KINDS) replaces the kind the seed draws."""
    rng = random.Random(seed)
    drawn = rng.choices(KINDS, KIND_WEIGHTS)[0]
    kind = kind or drawn
    d = os.path.join(work, str(seed))
    os.makedirs(d, exist_ok=True)
    make = {"genomic": make_genomic, "splice": make_splice, "pe": make_pe,
            "long": make_long, "ava": make_ava, "asm": make_asm}[kind]
    flags, files = make(rng, d, seed, scale)
    return Workload(seed, kind, flags, files, rng.choice(THREADS), d)


def aligns(flags) -> bool:
    """Whether a flag set asks for base-level alignment."""
    return any(f in ALIGN_FLAGS or f.startswith("--cs") for f in flags)


def device_argv(w: Workload) -> list:
    """The device side's arguments: the drawn flags without --tpu-*, with
    --gpu-chain, and --gpu-align where they align."""
    flags = [f for f in w.flags if not f.startswith("--tpu")]
    return ([SKIP_INF, "-t", str(w.threads), "--gpu-chain"]
            + (["--gpu-align"] if aligns(flags) else []) + flags + w.files)


def reference_argv(w: Workload) -> list:
    """The reference side's arguments: the drawn flags without --tpu-*
    and --gpu-*, a --split-prefix of its own (both sides run at once)."""
    out, prev = [], None
    for f in w.flags:
        if not f.startswith(("--tpu", "--gpu")):
            out.append(f + ".ref" if prev == "--split-prefix" else f)
        prev = f
    return [SKIP_INF, "-t", str(w.threads)] + out + w.files


def run_device(argv, device):
    """The port's run path in this process: (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            argv, args = cli.parse_args(argv)
            io_, mo = O.set_preset(args.preset)
            rc = cli._run(args, argv, io_, mo, device)
        except SystemExit as e:   # the parser's usage errors
            rc = e.code if isinstance(e.code, int) else 1
    return rc, out.getvalue(), err.getvalue()


def run_reference(cmd, argv):
    """The reference command in a subprocess: (rc, stdout, stderr); a
    time-out is rc -9."""
    env = {k: v for k, v in os.environ.items() if k not in REF_ENV_DROP}
    try:
        p = subprocess.run(cmd + argv, cwd=REPO, env=env, text=True,
                           capture_output=True, timeout=REF_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        return -9, "", f"timed out after {e.timeout} s"
    return p.returncode, p.stdout, p.stderr


def _no_pg(s: str) -> list:
    return [line for line in s.splitlines(keepends=True)
            if not line.startswith("@PG")]


# the port's launch counters: (module, attribute) by kernel and mode
COUNTERS = {
    "chain_segments": (chain_gpu, "launches"),
    "extd2_fill": (ksw2_gpu, "fill_launches"),
    "extd2_ext": (ksw2_gpu, "ext_launches"),
    "ksw2_backtrack": (ksw2_gpu, "backtrack_launches"),
    "ksw2_backtrack_intron": (ksw2_gpu, "intron_backtrack_launches"),
    "ksw2_backtrack_starts": (ksw2_gpu, "start_backtrack_launches"),
    "exts2_fill": (ksw2s_gpu, "fill_launches"),
    "exts2_ext": (ksw2s_gpu, "ext_launches"),
}
# the `-v 3` lines' host routes
ROUTES = (
    ("hpc_host_batches", r"host route: (\d+) HPC batches"),
    ("rmq_host_batches", r"HPC batches, (\d+) RMQ batches"),
    ("fills", r"fills: (\d+) \("),
    ("fills_host", r"fills: \d+ \(\d+ device, (\d+) host-routed\)"),
    ("extensions", r"extensions: (\d+) \("),
    ("extensions_host", r"extensions: \d+ \(\d+ device, (\d+) host-routed"),
    ("misses_fill", r"aligned on the host\): (\d+) fill"),
    ("misses_ext", r"aligned on the host\): \d+ fill, (\d+) ext"),
    ("misses_splice", r"aligned on the host\): \d+ fill, \d+ ext, (\d+) "
                      r"splice"),
    ("host_chain_fallback", r"(falling back to host chaining)"),
)


def launch_counts() -> Counter:
    """The port's launch counters and launch classes now."""
    c = Counter({k: getattr(m, a) for k, (m, a) in COUNTERS.items()})
    for m in (chain_gpu, ksw2_gpu):
        c.update({f"{k}/{cls}": n for (k, cls), n in
                  m.launch_classes.items()})
    return c


def routes(err: str) -> Counter:
    """The host-routed counts of a run's `-v 3` lines, summed."""
    c = Counter()
    for name, pat in ROUTES:
        for m in re.findall(pat, err):
            c[name] += 1 if name == "host_chain_fallback" else int(m)
    return c


@dataclass
class SeedResult:
    w: Workload
    ok: bool
    rc: tuple           # (device, reference)
    lines: tuple        # line counts (device, reference), @PG aside
    first_diff: str     # the first differing line, or ""
    launches: Counter   # kernel launches and classes of the device run
    routes: Counter
    seconds: float      # the device run's wall
    error: str = ""     # the device side's traceback or stderr tail
    faults: int = 0     # an ava seed's lines that break its filters

    @property
    def empty(self) -> bool:
        """Both sides exited 0 with no output line: a vacuous match."""
        return self.rc == (0, 0) and self.lines == (0, 0)

    def line(self) -> str:
        w = self.w
        head = (f"seed={w.seed} {w.kind:8s} -t {w.threads} "
                f"flags={' '.join(w.flags) or '(default)'}")
        if self.ok:
            return (f"ok   {head} lines={self.lines[1]} "
                    f"{self.seconds:.2f} s")
        msg = (f"FAIL {head} rc={self.rc[0]} ref_rc={self.rc[1]} "
               f"line counts: ours={self.lines[0]} ref={self.lines[1]}"
               + (f" overlap-filter faults={self.faults}" if self.faults
                  else "")
               + (" both outputs empty" if self.empty else "")
               + f" (files kept in {w.work})")
        if self.first_diff:
            msg += "\n" + self.first_diff
        if self.error:
            msg += "\n  device stderr: " + self.error[-1500:]
        return msg


def compare(w: Workload, dev, ref, launches, seconds) -> SeedResult:
    """The seed's result from the two sides' (rc, stdout, stderr)."""
    a, b = _no_pg(dev[1]), _no_pg(ref[1])
    diff = ""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            diff = (f"  line {i}:\n   ref: {y.rstrip()[:160]}\n"
                    f"   our: {x.rstrip()[:160]}")
            break
    faults = len(ava_order_faults(dev[1])) if w.kind == "ava" else 0
    vacuous = w.kind in OTHER_KINDS and not a and not b
    ok = (dev[0] == 0 and ref[0] == 0 and a == b and not faults
          and not vacuous)
    error = "" if dev[0] == 0 else dev[2]
    if ref[0] != 0:
        error += "\n  reference stderr: " + ref[2][-1500:]
    return SeedResult(w, ok, (dev[0], ref[0]), (len(a), len(b)), diff,
                      launches, routes(dev[2]), seconds, error, faults)


def run_seed(w: Workload, device, ref) -> SeedResult:
    """One seed: the device side here, `ref(argv)` (the reference side's
    (rc, stdout, stderr), or a future of it) compared byte for byte."""
    before = launch_counts()
    t0 = time.perf_counter()
    try:
        dev = run_device(device_argv(w), device)
    except Exception:   # a seed's failure is reported, not raised
        dev = (-1, "", traceback.format_exc())
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    launches.subtract(before)
    ref_out = ref(reference_argv(w)) if callable(ref) else ref.result()
    return compare(w, dev, ref_out, +launches, seconds)


@dataclass
class Campaign:
    results: list = field(default_factory=list)

    @property
    def failed(self) -> list:
        return [r for r in self.results if not r.ok]

    def totals(self) -> dict:
        launches, rts, kinds, threads, empty = (Counter() for _ in range(5))
        for r in self.results:
            launches.update(r.launches)
            rts.update(r.routes)
            kinds[r.w.kind] += 1
            threads[str(r.w.threads)] += 1
            if r.empty:   # by flag set, the seed's own paths aside
                flags = [f for f in r.w.flags if not f.startswith(r.w.work)]
                empty[" ".join([r.w.kind, *flags])] += 1
        return {"seeds": len(self.results),
                "matched": len(self.results) - len(self.failed),
                "kinds": dict(kinds), "threads": dict(sorted(threads.items())),
                "empty": dict(sorted(empty.items())),
                "launches": {k: launches[k] for k in sorted(launches)
                             if "/" not in k},
                "classes": {k: launches[k] for k in sorted(launches)
                            if "/" in k},
                "routes": dict(sorted(rts.items())),
                "seeds_with": {k: sum(1 for r in self.results
                                      if r.launches[k] > 0)
                               for k in COUNTERS}}

    def summary(self) -> str:
        t = self.totals()
        lines = [f"{t['matched']}/{t['seeds']} matched; kinds "
                 f"{t['kinds']}; -t {t['threads']}"]
        for k in COUNTERS:
            cls = {c.split("/")[1]: n for c, n in t["classes"].items()
                   if c.split("/")[0] == k}
            lines.append(f"  {k}: {t['launches'].get(k, 0)} launches in "
                         f"{t['seeds_with'][k]} seeds; classes {cls}")
        lines.append("  exts2_ext has no CLI caller (the splice extensions "
                     "align on the host, as in the JAX package)")
        lines.append(f"  routes: {t['routes']}")
        lines.append(f"  both outputs empty: {sum(t['empty'].values())} "
                     f"seeds, by kind and flags {t['empty']}")
        return "\n".join(lines)


def campaign(seeds, device, work=WORK, ref_cmd=None, scale=1, out=None,
             ref=None, kind=None) -> Campaign:
    """Run the seeds; each result's line goes to out (stdout by default)
    as it comes.  ref: a callable argv -> (rc, stdout, stderr) run after
    the device side (in this process: the tests), else ref_cmd in
    subprocesses, up to REF_AHEAD of them ahead of the device side.  kind:
    one of OTHER_KINDS for every seed, else each seed's drawn kind.  A
    matching seed's files are removed."""
    seeds, out = list(seeds), out or sys.stdout
    res = Campaign()
    cmd = list(ref_cmd or REF_CMD)
    depth = 1 if ref is not None else REF_AHEAD
    with ThreadPoolExecutor(depth) as pool:
        ahead = deque()
        for i, seed in enumerate(seeds):
            w = make_workload(seed, work, scale, kind)
            ahead.append((w, ref if ref is not None else pool.submit(
                run_reference, cmd, reference_argv(w))))
            last = i == len(seeds) - 1
            while ahead and (len(ahead) >= depth or last):
                w, fut = ahead.popleft()
                r = run_seed(w, device, fut)
                res.results.append(r)
                print(r.line(), file=out, flush=True)
                if r.ok:
                    shutil.rmtree(w.work, ignore_errors=True)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mm2_gb_tpu_torch.tools.fuzz_diff",
        description="the port's --gpu-chain run path against its host "
                    "route on seeded workloads")
    p.add_argument("n", type=int, nargs="?", default=20)
    p.add_argument("seed0", type=int, nargs="?", default=1000)
    p.add_argument("--work", default=WORK)
    p.add_argument("--ref-cmd", default=None,
                   help="the reference command (default: python -m "
                        "mm2_gb_tpu_torch --device cpu, the port's host "
                        "route, from the repository's root)")
    p.add_argument("--device", default="cuda",
                   help="the device side's device: cuda, or cpu for the "
                        "same device route on the kernels' plain twins "
                        "(not the CLI's --device cpu: the reference side "
                        "is the host route either way)")
    p.add_argument("--kind", choices=OTHER_KINDS, default=None,
                   help="give every seed this kind, which no seed draws "
                        "(ava: reads against themselves at -x ava-*; asm: "
                        "contigs against their reference at -x asm*)")
    a = p.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("fuzz_diff: no CUDA device (--device cpu runs the device "
              "side on the plain twins)", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    c = campaign(range(a.seed0, a.seed0 + a.n), device, a.work,
                 shlex.split(a.ref_cmd) if a.ref_cmd else None, kind=a.kind)
    print(f"\n{c.summary()}\n{time.perf_counter() - t0:.1f} s on {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    return 1 if c.failed else 0


if __name__ == "__main__":
    sys.exit(main())
