"""Command-line driver (main.c analog): the minimap2 flag surface, with
chaining and gap fills on the GPU.

Usage:
    python -m mm2_gb_tpu_torch [options] <target.fa> <query.fa> [...]
    python -m mm2_gb_tpu_torch --gpu-chain --max-chain-skip=2147483647 \\
        ref.fa reads.fa > out.paf
    python -m mm2_gb_tpu_torch --device cpu [options] ref.fa reads.fa

Options are applied in two passes like the reference (main.c:146-160):
presets (-x) first, explicit flags second.  The parser, the option
overrides, the usage block and the record writer are copies of the JAX
package's (mm2_gb_tpu/cli.py).  `--device {cuda,cpu}` is the port's own
flag, read by `main` before the parser sees the arguments.  With
`--device cuda`, the default, `main` maps through models.pipeline, which
chains on the CUDA device (--gpu-chain is implied); a run with no CUDA
device fails rather than falling back to the CPU.  `--device cpu` runs
the host path of `_run` (models.stream), the JAX package's default
route, byte for byte, and imports no torch; it takes no device flag.
--gpu-align (the JAX package's --tpu-align) adds the gap fills and
extensions of -c runs on the device.  The JAX package's scale-out flags
map as there: --tpu-devices N shards each batch's reads over N devices
(parallel.mesh), --tpu-nproc/--tpu-rank/--tpu-coord write one rank's
round-robin share into OUT.shard<rank> for tools/mergeshards.py,
--tpu-profile DIR writes a torch.profiler trace of the mapping run (with
the main thread's stages as ranges, utils.timeline.span), and a
multi-part index (-I, --split-prefix) maps one single-segment query
file part by part on the device.  The --gpu-* spellings of these flags
are accepted too.  Several query files over a multi-part index,
fragment mode and a prebuilt multi-part index keep the host chaining
routes (with the JAX package's warnings).
"""

from __future__ import annotations

import argparse
import os
import sys

from mm2_gb_tpu_torch.utils import opts as O
from mm2_gb_tpu_torch.utils import timeline

# the port's spellings of the parser's TPU flags (parse_args)
_GPU_FLAGS = {f"--gpu-{name}": f"--tpu-{name}" for name in
              ("align", "devices", "nproc", "rank", "coord", "profile")}

# the port's --device flag (main), after the copied usage block
_DEVICE_USAGE = ("  --device STR   cuda: map on the CUDA card; cpu: the host "
                 "path, with no device flag [cuda]\n")

_MULTIPART_WARNING = ("[WARNING] --tpu-chain with a multi-part index "
                      "supports one single-segment query file; falling "
                      "back to host chaining.\n")


def _parse_num(s: str) -> int:
    """mm_parse_num (main.c:99-115): float prefix + optional k/M/G suffix,
    rounded with +.499 like the reference."""
    import re
    m = re.match(r"\s*[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?", s)
    x = float(m.group(0)) if m else 0.0
    rest = s[m.end():] if m else s
    if rest[:1] in ("G", "g"):
        x *= 1e9
    elif rest[:1] in ("M", "m"):
        x *= 1e6
    elif rest[:1] in ("K", "k"):
        x *= 1e3
    return int(x + .499)


def build_parser() -> argparse.ArgumentParser:
    from mm2_gb_tpu_torch import __version__
    p = argparse.ArgumentParser(prog="mm2-gb-tpu", add_help=True)
    p.add_argument("target")
    p.add_argument("query", nargs="*")
    p.add_argument("-x", dest="preset", default=None)
    p.add_argument("-k", type=int, default=None)
    p.add_argument("-w", type=int, default=None)
    p.add_argument("-H", dest="hpc", action="store_true")
    p.add_argument("-f", dest="occ_frac", type=str, default=None)
    p.add_argument("-g", dest="max_gap", type=str, default=None)
    p.add_argument("-G", "--max-intron-len", dest="max_intron_len",
                   type=str, default=None)
    p.add_argument("-n", "--min-count", dest="min_cnt", type=int,
                   default=None)
    p.add_argument("-m", "--min-chain-score", dest="min_chain_score",
                   type=int, default=None)
    p.add_argument("-p", dest="pri_ratio", type=float, default=None)
    p.add_argument("-N", dest="best_n", type=int, default=None)
    p.add_argument("-r", dest="bw", type=str, default=None)
    p.add_argument("-V", "--version", action="version", version=__version__)
    p.add_argument("-c", dest="cigar", action="store_true")
    p.add_argument("-a", "--sam", dest="sam", action="store_true")
    p.add_argument("-t", dest="threads", type=int, default=3)
    p.add_argument("-d", dest="dump_index", default=None)
    p.add_argument("-o", dest="output", default=None)
    p.add_argument("-D", "--no-self", dest="no_diag", action="store_true")
    p.add_argument("-P", "--all-chain", dest="all_chain",
                   action="store_true")
    p.add_argument("-X", dest="ava", action="store_true")
    p.add_argument("-Q", dest="no_qual", action="store_true")
    p.add_argument("-Y", dest="softclip", action="store_true")
    p.add_argument("-L", dest="long_cigar", action="store_true")
    p.add_argument("-y", dest="copy_comment", action="store_true")
    p.add_argument("-2", dest="two_io_threads", action="store_true")
    p.add_argument("-e", dest="occ_dist", type=str, default=None)
    p.add_argument("-S", dest="deprecated_S", action="store_true")
    p.add_argument("--max-chain-skip", type=int, default=None)
    p.add_argument("--max-chain-iter", type=int, default=None)
    p.add_argument("--rmq", nargs="?", const="yes", default=None)
    p.add_argument("--splice", action="store_true")
    p.add_argument("--sr", action="store_true")
    p.add_argument("--no-long-join", action="store_true")
    p.add_argument("--no-pairing", action="store_true")
    p.add_argument("--splice-flank", default=None, metavar="yes|no")
    p.add_argument("--heap-sort", default=None, metavar="yes|no")
    p.add_argument("--dual", default=None, metavar="yes|no")
    p.add_argument("--no-end-flt", action="store_true")
    p.add_argument("--hard-mask-level", action="store_true")
    p.add_argument("--no-hash-name", action="store_true")
    p.add_argument("--end-bonus", type=int, default=None)
    p.add_argument("--end-seed-pen", type=int, default=None)
    p.add_argument("--min-dp-len", type=int, default=None)
    p.add_argument("-s", "--min-dp-score", dest="min_dp_max", type=int,
                   default=None)
    p.add_argument("--score-N", dest="score_n", type=int, default=None)
    p.add_argument("--mask-len", type=str, default=None)
    p.add_argument("--max-clip-ratio", type=float, default=None)
    p.add_argument("--max-qlen", type=str, default=None)
    p.add_argument("--cap-sw-mem", type=str, default=None)
    p.add_argument("--cap-kalloc", type=str, default=None)
    p.add_argument("--no-kalloc", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--q-occ-frac", type=float, default=None)
    p.add_argument("--chain-gap-scale", type=float, default=None)
    p.add_argument("--chain-skip-scale", type=float, default=None)
    p.add_argument("--bucket-bits", type=int, default=None)
    p.add_argument("--idx-no-seq", action="store_true")
    p.add_argument("--lj-min-ratio", type=float, default=None)
    p.add_argument("--print-qname", action="store_true")
    p.add_argument("--print-aln-seq", action="store_true")
    p.add_argument("--tpu-chain", "--gpu-chain", action="store_true",
                   help="run chaining on the TPU (mm2-gb's --gpu-chain; "
                        "the alias is accepted for drop-in use)")
    p.add_argument("--tpu-align", action="store_true",
                   help="batch gap-fill extension DP on the TPU")
    p.add_argument("--tpu-devices", type=int, default=1,
                   help="data-parallel device count for --tpu-chain "
                        "(0 = all local devices)")
    p.add_argument("--tpu-nproc", type=int, default=1,
                   help="multi-host process count; each rank maps its "
                        "round-robin read share into -o OUT.shard<rank>")
    p.add_argument("--tpu-rank", type=int, default=0)
    p.add_argument("--tpu-coord", default=None,
                   help="torch.distributed rendezvous address "
                        "(host:port) of the ranks")
    p.add_argument("--tpu-profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace (Chrome trace "
                        "JSON, CPU and CUDA activities) of the mapping "
                        "run into DIR")
    p.add_argument("--tpu-cfg", "--gpu-cfg", default=None,
                   help="device batch config JSON (mm2-gb's --gpu-cfg; "
                        "the alias is accepted for drop-in use)")
    p.add_argument("-u", dest="splice_strand", choices=["f", "b", "r", "n"],
                   default=None)
    p.add_argument("-C", "--cost-non-gt-ag", dest="noncan", type=int,
                   default=None)
    p.add_argument("--cs", nargs="?", const="short",
                   choices=["short", "long"], default=None)
    p.add_argument("--MD", action="store_true")
    p.add_argument("--eqx", action="store_true")
    p.add_argument("-R", dest="rg", default=None,
                   help="SAM read group line (@RG\\tID:...)")
    p.add_argument("--sam-hit-only", action="store_true")
    p.add_argument("--secondary", choices=["yes", "y", "no", "n"],
                   default=None)
    p.add_argument("--paf-no-hit", action="store_true")
    p.add_argument("--frag", choices=["yes", "y", "no", "n"], default=None)
    p.add_argument("-F", dest="max_frag_len", type=int, default=None)
    p.add_argument("-T", dest="sdust_thres", type=int, default=None)
    p.add_argument("-A", dest="match_sc", type=int, default=None)
    p.add_argument("-B", dest="mismatch_sc", type=int, default=None)
    p.add_argument("-O", dest="gap_open", default=None)
    p.add_argument("-E", dest="gap_ext", default=None)
    p.add_argument("-z", dest="zdrop", default=None)
    p.add_argument("-U", dest="occ_range", default=None)
    p.add_argument("-M", "--mask-level", dest="mask_level", type=float,
                   default=None)
    p.add_argument("--min-occ-floor", type=int, default=None)
    p.add_argument("-K", "--mb-size", dest="mini_batch", default=None,
                   help="minibatch size in bases (500M default; k/M/G suffix)")
    p.add_argument("-v", dest="verbose", type=int, default=3)  # main.c:141
    p.add_argument("-I", dest="batch_size", default=None,
                   help="split index for every ~NUM bases (k/M/G suffix)")
    p.add_argument("--split-prefix", default=None)
    p.add_argument("--junc-bed", default=None)
    p.add_argument("--junc-bonus", type=int, default=None)
    p.add_argument("--alt", dest="alt_list", default=None)
    p.add_argument("--alt-drop", type=float, default=None)
    p.add_argument("--for-only", action="store_true")
    p.add_argument("--qstrand", action="store_true")
    p.add_argument("--rev-only", action="store_true")
    p.add_argument("--print-seeds", action="store_true")
    p.add_argument("--print-chains", action="store_true")
    return p


def _yes_or_no(mo, flag: int, name: str, arg: str, yes_to_set: bool) -> None:
    """yes_or_no (main.c:117-128): set/clear flag, warn on bad values."""
    if arg in ("yes", "y"):
        if yes_to_set:
            mo.flag |= flag
        else:
            mo.flag &= ~flag
    elif arg in ("no", "n"):
        if yes_to_set:
            mo.flag &= ~flag
        else:
            mo.flag |= flag
    else:
        sys.stderr.write(f"[WARNING] option '--{name}' only accepts 'yes' "
                         "or 'no'.\n")


def apply_overrides(args, io: O.IndexOptions, mo: O.MapOptions) -> None:
    if args.k is not None:
        io.k = args.k
    if args.w is not None:
        io.w = args.w
    if args.hpc:
        io.flag |= O.MM_I_HPC
    if args.bucket_bits is not None:
        io.bucket_bits = args.bucket_bits
    if args.idx_no_seq:
        io.flag |= O.MM_I_NO_SEQ
    if args.occ_frac is not None:  # -f frac-or-count[,max-occ] (main.c:288-293)
        parts = args.occ_frac.split(",")
        x = float(parts[0])
        if x < 1.0:
            mo.mid_occ_frac, mo.mid_occ = x, 0
        else:
            mo.mid_occ = int(x + .499)
        if len(parts) > 1:
            mo.max_occ = int(float(parts[1]) + .499)
    if args.max_gap is not None:
        mo.max_gap = _parse_num(args.max_gap)
    if args.min_cnt is not None:
        mo.min_cnt = args.min_cnt
    if args.min_chain_score is not None:
        mo.min_chain_score = args.min_chain_score
    if args.pri_ratio is not None:
        mo.pri_ratio = args.pri_ratio
    if args.best_n is not None:
        if args.best_n == 0:  # main.c:337-340
            sys.stderr.write("[WARNING] changed '-N 0' to '-N %d "
                             "--secondary=no'.\n" % mo.best_n)
            mo.flag |= O.MM_F_NO_PRINT_2ND
        else:
            mo.best_n = args.best_n
    if args.bw is not None:
        parts = args.bw.split(",")
        mo.bw = _parse_num(parts[0])
        if len(parts) > 1:
            mo.bw_long = _parse_num(parts[1])
    if args.max_chain_skip is not None:
        mo.max_chain_skip = args.max_chain_skip
    if args.max_chain_iter is not None:
        mo.max_chain_iter = args.max_chain_iter
    if args.rmq is not None:
        _yes_or_no(mo, O.MM_F_RMQ, "rmq", args.rmq, True)
    if args.splice:
        mo.flag |= O.MM_F_SPLICE
    if args.sr:
        mo.flag |= O.MM_F_SR
    if args.no_diag:
        mo.flag |= O.MM_F_NO_DIAG
    if args.all_chain:
        mo.flag |= O.MM_F_ALL_CHAINS
    if args.ava:  # -X = -D -P --no-long-join --dual=no (main.c:178)
        mo.flag |= (O.MM_F_ALL_CHAINS | O.MM_F_NO_DIAG | O.MM_F_NO_DUAL
                    | O.MM_F_NO_LJOIN)
    if args.no_qual:
        mo.flag |= O.MM_F_NO_QUAL
    if args.softclip:
        mo.flag |= O.MM_F_SOFTCLIP
    if args.long_cigar:
        mo.flag |= O.MM_F_LONG_CIGAR
    if args.copy_comment:
        mo.flag |= O.MM_F_COPY_COMMENT
    if args.two_io_threads:
        mo.flag |= O.MM_F_2_IO_THREADS
    if args.no_long_join:
        mo.flag |= O.MM_F_NO_LJOIN
    if args.no_pairing:
        mo.flag |= O.MM_F_INDEPEND_SEG
    if args.splice_flank is not None:
        _yes_or_no(mo, O.MM_F_SPLICE_FLANK, "splice-flank",
                   args.splice_flank, True)
    if args.heap_sort is not None:
        _yes_or_no(mo, O.MM_F_HEAP_SORT, "heap-sort", args.heap_sort, True)
    if args.dual is not None:  # yes clears NO_DUAL (main.c:267-268)
        _yes_or_no(mo, O.MM_F_NO_DUAL, "dual", args.dual, False)
    if args.no_end_flt:
        mo.flag |= O.MM_F_NO_END_FLT
    if args.hard_mask_level:
        mo.flag |= O.MM_F_HARD_MLEVEL
    if args.no_hash_name:
        mo.flag |= O.MM_F_NO_HASH_NAME
    if args.end_bonus is not None:
        mo.end_bonus = args.end_bonus
    if args.end_seed_pen is not None:
        mo.anchor_ext_shift = args.end_seed_pen
    if args.min_dp_len is not None:
        mo.min_ksw_len = args.min_dp_len
    if args.score_n is not None:
        mo.sc_ambi = args.score_n
    if args.mask_len is not None:
        mo.mask_len = _parse_num(args.mask_len)
    if args.max_clip_ratio is not None:
        mo.max_clip_ratio = args.max_clip_ratio
    if args.max_qlen is not None:
        mo.max_qlen = _parse_num(args.max_qlen)
    if args.cap_sw_mem is not None:
        mo.max_sw_mat = _parse_num(args.cap_sw_mem)
    if args.cap_kalloc is not None:  # arena knob; NumPy owns memory here
        mo.cap_kalloc = _parse_num(args.cap_kalloc)
    if args.seed is not None:
        mo.seed = args.seed
    if args.q_occ_frac is not None:
        mo.q_occ_frac = args.q_occ_frac
    if args.chain_gap_scale is not None:
        mo.chain_gap_scale = args.chain_gap_scale
    if args.chain_skip_scale is not None:
        mo.chain_skip_scale = args.chain_skip_scale
    if args.occ_dist is not None:
        mo.occ_dist = _parse_num(args.occ_dist)
    if args.lj_min_ratio is not None:
        sys.stderr.write("[WARNING]  --lj-min-ratio has been deprecated.\n")
    if args.deprecated_S:  # main.c:272-275
        mo.flag |= O.MM_F_OUT_CS | O.MM_F_CIGAR | O.MM_F_OUT_CS_LONG
        sys.stderr.write("[WARNING] option -S is deprecated and may be "
                         "removed in future. Please use --cs=long instead.\n")
    if args.cigar:
        mo.flag |= O.MM_F_CIGAR | O.MM_F_OUT_CG
    if args.sam:
        mo.flag |= O.MM_F_CIGAR | O.MM_F_OUT_SAM
    if args.cs == "short":
        mo.flag |= O.MM_F_OUT_CS | O.MM_F_CIGAR
    elif args.cs == "long":
        mo.flag |= O.MM_F_OUT_CS | O.MM_F_CIGAR | O.MM_F_OUT_CS_LONG
    if args.MD:
        mo.flag |= O.MM_F_OUT_MD | O.MM_F_CIGAR
    if args.eqx:
        mo.flag |= O.MM_F_EQX
    if args.sam_hit_only:
        mo.flag |= O.MM_F_SAM_HIT_ONLY
    if args.splice_strand is not None:  # main.c:199-205
        mo.flag &= ~(O.MM_F_SPLICE_FOR | O.MM_F_SPLICE_REV)
        if args.splice_strand == "f":
            mo.flag |= O.MM_F_SPLICE_FOR
        elif args.splice_strand == "r":
            mo.flag |= O.MM_F_SPLICE_REV
        elif args.splice_strand == "b":
            mo.flag |= O.MM_F_SPLICE_FOR | O.MM_F_SPLICE_REV
    if args.noncan is not None:
        mo.noncan = args.noncan
    if args.frag in ("yes", "y"):
        mo.flag |= O.MM_F_FRAG_MODE
    elif args.frag in ("no", "n"):
        mo.flag &= ~O.MM_F_FRAG_MODE
    if args.max_frag_len is not None:
        mo.max_frag_len = args.max_frag_len
    if args.sdust_thres is not None:
        mo.sdust_thres = args.sdust_thres
    if args.match_sc is not None:
        mo.a = args.match_sc
    if args.mismatch_sc is not None:
        mo.b = args.mismatch_sc
    if args.gap_open is not None:  # -O open[,open2] (main.c:189-192)
        parts = args.gap_open.split(",")
        mo.q = mo.q2 = int(parts[0])
        if len(parts) > 1:
            mo.q2 = int(parts[1])
    if args.gap_ext is not None:  # -E ext[,ext2]
        parts = args.gap_ext.split(",")
        mo.e = mo.e2 = int(parts[0])
        if len(parts) > 1:
            mo.e2 = int(parts[1])
    if args.zdrop is not None:  # -z zdrop[,zdrop_inv]
        parts = args.zdrop.split(",")
        mo.zdrop = mo.zdrop_inv = int(parts[0])
        if len(parts) > 1:
            mo.zdrop_inv = int(parts[1])
    if args.min_dp_max is not None:
        mo.min_dp_max = args.min_dp_max
    if args.occ_range is not None:  # -U min[,max] occurrence bounds
        parts = args.occ_range.split(",")
        mo.min_mid_occ = int(parts[0])
        if len(parts) > 1:
            mo.max_mid_occ = int(parts[1])
    if args.mask_level is not None:
        mo.mask_level = args.mask_level
    if args.min_occ_floor is not None:
        mo.min_mid_occ = args.min_occ_floor
    if args.mini_batch is not None:
        s = args.mini_batch
        mult = {"k": 10**3, "K": 10**3, "m": 10**6, "M": 10**6,
                "g": 10**9, "G": 10**9}.get(s[-1], 1)
        mo.mini_batch_size = int(float(s[:-1] if mult > 1 else s) * mult)
    if args.secondary is not None:  # yes_or_no w/ yes_to_set=0 (main.c:252)
        _yes_or_no(mo, O.MM_F_NO_PRINT_2ND, "secondary", args.secondary,
                   False)
    if args.paf_no_hit:
        mo.flag |= O.MM_F_PAF_NO_HIT
    if args.for_only:
        mo.flag |= O.MM_F_FOR_ONLY
    if args.rev_only:
        mo.flag |= O.MM_F_REV_ONLY
    if args.qstrand:  # main.c:242
        mo.flag |= O.MM_F_QSTRAND | O.MM_F_NO_INV
    if args.print_seeds:  # --print-seeds implies QR dumps too (main.c:209)
        mo.dbg_print_seed = True
        mo.dbg_print_qname = True
    if args.print_chains:  # main.c:245
        mo.dbg_print_chain = True
    if args.print_qname:  # main.c:208
        mo.dbg_print_qname = True
    if args.print_aln_seq:  # main.c:213
        mo.dbg_print_aln_seq = True
        mo.dbg_print_qname = True
    if (mo.dbg_print_seed or mo.dbg_print_chain or mo.dbg_print_qname
            or mo.dbg_print_aln_seq):
        args.threads = 1   # keep dumps read-ordered (main.c:209,213)
    if args.tpu_chain:
        mo.flag |= O.MM_F_TPU_CHAIN
    if args.tpu_align:
        mo.flag |= O.MM_F_TPU_ALIGN
    if args.tpu_cfg:
        mo.tpu_config_file = args.tpu_cfg
        from mm2_gb_tpu_torch.utils.gpucfg import (apply_gpu_config,
                                                   load_gpu_config)
        apply_gpu_config(load_gpu_config(args.tpu_cfg))
    if args.max_intron_len is not None:
        # mm_mapopt_max_intron_len (options.c:84-88): only acts in splice
        # mode; applied after flags so --splice -G works in either order
        v = _parse_num(args.max_intron_len)
        if (mo.flag & O.MM_F_SPLICE) and v > 0:
            mo.max_gap_ref = mo.bw = mo.bw_long = v
    if mo.flag & O.MM_F_SR:  # mm2-gb: SR forces exhaustive DP (main.c:316-319)
        mo.max_chain_skip = 2**31 - 1


_USAGE = """\
Usage: mm2-gb-tpu [options] <target.fa>|<target.idx> [query.fa] [...]
Options:
  Indexing:
    -H           use homopolymer-compressed k-mer (preferrable for PacBio)
    -k INT       k-mer size (no larger than 28) [15]
    -w INT       minimizer window size [10]
    -I NUM       split index for every ~NUM input bases [4G]
    -d FILE      dump index to FILE []
  Mapping:
    -f FLOAT     filter out top FLOAT fraction of repetitive minimizers [0.0002]
    -g NUM       stop chain enlongation if there are no minimizers in INT-bp [5000]
    -G NUM       max intron length (effective with -xsplice; changing -r) [200k]
    -F NUM       max fragment length (effective with -xsr or in the fragment mode) [800]
    -r NUM[,NUM] chaining/alignment bandwidth and long-join bandwidth [500,20000]
    -n INT       minimal number of minimizers on a chain [3]
    -m INT       minimal chaining score (matching bases minus log gap penalty) [40]
    -X           skip self and dual mappings (for the all-vs-all mode)
    -p FLOAT     min secondary-to-primary score ratio [0.8]
    -N INT       retain at most INT secondary alignments [5]
  Alignment:
    -A INT       matching score [2]
    -B INT       mismatch penalty (larger value for lower divergence) [4]
    -O INT[,INT] gap open penalty [4,24]
    -E INT[,INT] gap extension penalty; a k-long gap costs min{O1+k*E1,O2+k*E2} [2,1]
    -z INT[,INT] Z-drop score and inversion Z-drop score [400,200]
    -s INT       minimal peak DP alignment score [80]
    -u CHAR      how to find GT-AG. f:transcript strand, b:both strands, n:don't match GT-AG [n]
  Input/Output:
    -a           output in the SAM format (PAF by default)
    -o FILE      output alignments to FILE [stdout]
    -L           write CIGAR with >65535 ops at the CG tag
    -R STR       SAM read group line in a format like '@RG\\tID:foo\\tSM:bar' []
    -c           output CIGAR in PAF
    --cs[=STR]   output the cs tag; STR is 'short' (if absent) or 'long' [none]
    --MD         output the MD tag
    --eqx        write =/X CIGAR operators
    -Y           use soft clipping for supplementary alignments
    -t INT       number of threads [3]
    -K NUM       minibatch size for mapping [500M]
    -v INT       verbose level [3]
    --version    show version number
  TPU:
    --tpu-chain  run anchor chaining on the TPU (the --gpu-chain analog)
    --tpu-align  also run alignment DP fills/extensions on the TPU
    --tpu-devices INT  data-parallel device count (0 = all) [1]
    --tpu-cfg FILE     device tuning JSON (the --gpu-cfg analog) []
  Preset:
    -x STR       preset (always applied before other options) []
                 - map-pb/map-ont - PacBio CLR/Nanopore vs reference mapping
                 - map-hifi - PacBio HiFi reads vs reference mapping
                 - ava-pb/ava-ont - PacBio/Nanopore read overlap
                 - asm5/asm10/asm20 - asm-to-ref mapping, for ~0.1/1/5%% sequence divergence
                 - splice/splice:hq - long-read/Pacbio-CCS spliced alignment
                 - sr - genomic short-read mapping
"""


def _tpu_spelling(a: str) -> str:
    """--gpu-X[=v] as the parser's --tpu-X[=v] (_GPU_FLAGS); else a."""
    name, eq, val = a.partition("=")
    return _GPU_FLAGS[name] + eq + val if name in _GPU_FLAGS else a


def parse_args(argv: list[str]):
    """(argv, args) as the run sees them: --cs takes an OPTIONAL =fmt
    (main.c:231-236), and the --gpu-align, --gpu-devices, --gpu-nproc,
    --gpu-rank, --gpu-coord and --gpu-profile spellings are the parser's
    --tpu-* flags."""
    argv = ["--cs=short" if a == "--cs" else _tpu_spelling(a) for a in argv]
    return argv, build_parser().parse_args(argv)


def take_device(argv: list[str]) -> tuple[str, list[str]]:
    """(device, argv without it): the port's `--device cuda|cpu` (also
    `--device=X`; the last one given wins), "cuda" when absent.  Raises
    ValueError on another value or a missing one."""
    device, rest, i = "cuda", [], 0
    while i < len(argv):
        name, eq, val = argv[i].partition("=")
        if name != "--device":
            rest.append(argv[i])
            i += 1
            continue
        if not eq:
            if i + 1 == len(argv):
                raise ValueError("--device needs a value: cuda or cpu")
            val = argv[i + 1]
        i += 1 if eq else 2
        if val not in ("cuda", "cpu"):
            raise ValueError(f"--device takes cuda or cpu, not '{val}'")
        device = val
    return device, rest


def device_flags(argv: list[str]) -> list[str]:
    """The device flags (the parser's --tpu-* options) that argv gives,
    in their --gpu-* spelling: by name or prefix, at any value, the
    default included."""
    p = build_parser()
    dests = [d for d in vars(p.parse_args(argv)) if d.startswith("tpu_")]
    p.set_defaults(**dict.fromkeys(dests))
    args = p.parse_args(argv)
    return ["--gpu-" + d[4:].replace("_", "-") for d in dests
            if getattr(args, d) is not None]


def main(argv: list[str] | None = None) -> int:
    """The port's entry point.  `--device cuda` (the default) maps on the
    CUDA device, as if --gpu-chain were given; `--device cpu` runs the
    host path, the JAX package's default route, and refuses the device
    flags (device_flags)."""
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if not argv:  # reference-style usage block (main.c:475-530)
        sys.stderr.write(_USAGE.replace("%%", "%") + _DEVICE_USAGE)
        return 1
    try:
        device, argv = take_device(argv)
    except ValueError as e:
        sys.stderr.write(f"[ERROR] {e}\n")
        return 1
    argv, args = parse_args(argv)
    if device == "cpu":
        given = device_flags(argv)
        if given:
            sys.stderr.write("[ERROR] --device cpu maps on the host and "
                             "takes no device flag: "
                             f"{', '.join(given)}\n")
            return 1
    else:
        args.tpu_chain = True
    try:
        io, mo = O.set_preset(args.preset)
    except ValueError as e:
        sys.stderr.write(f"[ERROR] {e}\n")
        return 1
    try:
        return _run(args, argv, io, mo)
    except FileNotFoundError as e:  # main.c:414 open-failure message
        sys.stderr.write(f"[ERROR] failed to open file '{e.filename}': "
                         "No such file or directory\n")
        return 1


def _parse_batch_size(s: str) -> int:
    mult = {"k": 10**3, "K": 10**3, "m": 10**6, "M": 10**6,
            "g": 10**9, "G": 10**9}.get(s[-1], 1)
    return int(float(s[:-1] if mult > 1 else s) * mult)


def _run(args, argv, io, mo, device="cuda") -> int:
    """One run (follows mm2_gb_tpu/cli.py:525-752): the host path, or with
    --gpu-chain the device pipeline on `device` (a CUDA device must be
    present when it is one)."""
    from mm2_gb_tpu_torch.models.index import MinimizerIndex, _is_mmi
    apply_overrides(args, io, mo)
    if (mo.flag & O.MM_F_SPLICE) and (mo.flag & O.MM_F_FRAG_MODE):
        sys.stderr.write("[ERROR] --splice and --frag should not be "
                         "specified at the same time.\n")  # main.c:321-324
        return 1
    try:
        O.check_opt(io, mo)
    except ValueError as e:
        sys.stderr.write(f"[ERROR] {e}\n")
        return 1
    if mo.flag & O.MM_F_TPU_CHAIN:
        import torch
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            sys.stderr.write("[ERROR] mm2_gb_tpu_torch needs a CUDA device "
                             "and PyTorch sees none; `--device cpu` maps "
                             "on the host.\n")
            return 1
        if args.tpu_nproc > 1:
            device = rank_device(device, args.tpu_rank)
    # -o (main.c:197-204 freopen); the ranks of a multi-process run write
    # shard files instead, with -o as the prefix
    if args.output and args.output != "-" and args.tpu_nproc <= 1:
        try:
            sys.stdout = open(args.output, "w")
        except OSError as e:
            sys.stderr.write(f"[ERROR] failed to write the output to file "
                             f"'{args.output}': {e.strerror}\n")
            return 1

    if args.dump_index and args.batch_size is not None \
            and not (args.target.endswith(".npz") or _is_mmi(args.target)):
        # -d with -I: successive parts append into ONE file in mmi
        # format regardless of its name (main.c:404+)
        from mm2_gb_tpu_torch.models.index import (from_fasta_parts,
                                                   save_mmi_parts)
        save_mmi_parts(from_fasta_parts(args.target, io,
                                        _parse_batch_size(args.batch_size)),
                       args.dump_index)
        if not args.query:
            return 0
        args.target = args.dump_index  # map against what was dumped
    if args.query and (args.batch_size is not None
                       or args.split_prefix is not None):
        # --split-prefix without -I still runs the dump+merge machinery
        # (main.c:471-472); each part maps on the device for one
        # single-segment query file, other shapes chain on the host
        if (mo.flag & O.MM_F_TPU_CHAIN) and (
                (mo.flag & O.MM_F_FRAG_MODE) or len(args.query) > 1):
            sys.stderr.write(_MULTIPART_WARNING)
            mo.flag &= ~(O.MM_F_TPU_CHAIN | O.MM_F_TPU_ALIGN)
        bs = (_parse_batch_size(args.batch_size)
              if args.batch_size is not None else io.batch_size)
        mo.split_prefix = args.split_prefix
        from mm2_gb_tpu_torch.models.splitmerge import map_multipart
        return map_multipart(args.target, args.query, io, mo, sys.stdout,
                             bs, args.split_prefix, args.rg, argv,
                             args.verbose, args.threads, device)
    if args.target.endswith(".npz") or _is_mmi(args.target):
        if _is_mmi(args.target) and args.query:
            # a prebuilt index may hold multiple parts; those go through
            # the per-part mapping (+ optional split merge) machinery
            from mm2_gb_tpu_torch.models.index import load_mmi_parts
            it = load_mmi_parts(args.target)
            index = next(it, None)
            if index is None:
                sys.stderr.write(f"[ERROR] failed to read the index "
                                 f"'{args.target}'.\n")
                return 1
            if next(it, None) is not None:
                from mm2_gb_tpu_torch.models.splitmerge import map_multipart
                if mo.flag & O.MM_F_TPU_CHAIN:
                    sys.stderr.write(_MULTIPART_WARNING)
                    mo.flag &= ~(O.MM_F_TPU_CHAIN | O.MM_F_TPU_ALIGN)
                mo.split_prefix = args.split_prefix
                return map_multipart(
                    args.target, args.query, io, mo, sys.stdout,
                    io.batch_size, args.split_prefix, args.rg, argv,
                    args.verbose, args.threads)
        else:
            index = MinimizerIndex.load(args.target)
        if (mo.flag & O.MM_F_CIGAR) and (index.flag & O.MM_I_NO_SEQ):
            sys.stderr.write("[ERROR] the prebuilt index doesn't contain "
                             "sequences.\n")  # main.c:406-408
            return 1
    else:
        timeline.mark("index build start")
        index = MinimizerIndex.from_fasta(args.target, io)
        timeline.mark("index built")
    if args.dump_index:
        index.save(args.dump_index)
        if not args.query:
            return 0
    if args.junc_bed:
        from mm2_gb_tpu_torch.models.index import read_junc_bed
        read_junc_bed(index, args.junc_bed, True)
    if args.alt_list:
        from mm2_gb_tpu_torch.models.index import read_alt_list
        n = read_alt_list(index, args.alt_list)
        if args.verbose >= 3:
            sys.stderr.write(f"[M::alt] found {n} ALT contigs\n")
    if args.junc_bonus is not None:
        mo.junc_bonus = args.junc_bonus
    if args.alt_drop is not None:
        mo.alt_drop = args.alt_drop
    O.mapopt_update(mo, index)
    if args.verbose >= 3:
        st = index.stats()
        sys.stderr.write(
            "[M::idx_stat] kmer size: %d; skip: %d; #seq: %d; "
            "total length: %d; distinct minimizers: %d; "
            "singletons: %.4f; occurrences: %d\n" % (
                index.k, index.w, st["n_seq"], st["total_len"],
                st["distinct_minimizers"], st["singleton_frac"],
                st["total_occurrences"]))

    out = sys.stdout
    is_sam = bool(mo.flag & O.MM_F_OUT_SAM)
    rg_id = None
    sam_header = None
    if (mo.flag & O.MM_F_TPU_CHAIN) and (mo.flag & O.MM_F_FRAG_MODE):
        # the reference's GPU path is single-segment only
        # (plchain.cu:499): chain multi-segment fragments on the host.
        # This precedes the SAM-header decision below, which keys on
        # MM_F_TPU_CHAIN for the multi-process ranks
        sys.stderr.write("[WARNING] --tpu-chain supports single-segment "
                         "reads only; falling back to host chaining.\n")
        mo.flag &= ~(O.MM_F_TPU_CHAIN | O.MM_F_TPU_ALIGN)
    if args.tpu_nproc > 1 and not (mo.flag & O.MM_F_TPU_CHAIN):
        # a rank that maps on the host cannot shard
        sys.stderr.write("[ERROR] --tpu-nproc requires --tpu-chain with "
                         "single-segment reads.\n")
        return 1
    if is_sam:
        from mm2_gb_tpu_torch.utils.sam import PG_VN, write_sam_header
        if args.rg:
            rg = args.rg.replace("\\t", "\t")
            rg_id = next((f[3:] for f in rg.split("\t")
                          if f.startswith("ID:")), None)
        sam_header = write_sam_header(index, args.rg, PG_VN, argv) + "\n"
        if not ((mo.flag & O.MM_F_TPU_CHAIN) and args.tpu_nproc > 1):
            out.write(sam_header)
        # else: rank 0 puts the header in its shard (_run_gpu_multihost)
    if not (mo.flag & O.MM_F_TPU_CHAIN):
        from mm2_gb_tpu_torch.models.stream import Metrics, map_file_stream
        metrics = Metrics()
        map_file_stream(index, mo, args.query, out, args.threads, rg_id,
                        metrics)
        metrics.report(args.verbose)
        return 0
    prof = None
    if args.tpu_profile:
        # one torch.profiler trace over the whole mapping run (the JAX
        # package's jax.profiler trace, cli.py:690-705)
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
        prof.start()
    try:
        # the trace holds the main thread's spans; none is kept besides
        with timeline.trace_only():
            if args.tpu_nproc > 1:
                return _run_gpu_multihost(args, index, mo, rg_id, is_sam,
                                          sam_header, device)
            return _run_gpu(args, index, mo, rg_id, is_sam, out, device)
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(args.tpu_profile, exist_ok=True)
            name = ("trace.json" if args.tpu_nproc <= 1
                    else f"trace.rank{args.tpu_rank}.json")
            prof.export_chrome_trace(os.path.join(args.tpu_profile, name))
            sys.stderr.write(f"[M::profile] trace written to "
                             f"{args.tpu_profile}\n")


def run_devices(n: int, device) -> list:
    """The devices of --tpu-devices n (0: all) on a run whose device is
    `device`: min(n, the CUDA devices PyTorch sees), as the JAX package
    takes min(n, its local devices) (cli.py:723-738); on the CPU n CPU
    devices (at least one)."""
    import torch
    if device.type != "cuda":
        return [torch.device("cpu")] * max(n, 1)
    avail = torch.cuda.device_count()
    return [torch.device("cuda", i)
            for i in range(avail if n == 0 else min(n, avail))]


def rank_device(device, rank: int):
    """The device of --tpu-rank `rank`: on a CUDA run without a device
    index, cuda:(rank % the CUDA devices PyTorch sees), as each JAX
    process maps on its own local device (mm2_gb_tpu/cli.py:775-779);
    else `device`."""
    import torch
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def _run_gpu(args, index, mo, rg_id, is_sam, out, device) -> int:
    """Map every query file on the device, or with --tpu-devices on
    several (parallel.mesh.map_file_multichip)."""
    from mm2_gb_tpu_torch.models.pipeline import (GpuMetrics,
                                                  map_file_gpu_records)
    from mm2_gb_tpu_torch.utils.gpucfg import derive_caps
    derive_caps(device, args.verbose)
    timeline.mark("mapping start")
    gmet = GpuMetrics()
    devices = run_devices(args.tpu_devices, device) \
        if args.tpu_devices != 1 else [device]
    if args.verbose >= 3:
        sys.stderr.write(f"[M::gpu] devices: {len(devices)} "
                         f"({', '.join(str(d) for d in devices)})\n")
    for q in args.query:  # per-file sequential (main.c:451-455)
        if len(devices) > 1:
            from mm2_gb_tpu_torch.parallel.mesh import map_file_multichip
            records = map_file_multichip(index, mo, [q], devices, gmet,
                                         args.threads)
        else:
            records = map_file_gpu_records(index, mo, [q], gmet,
                                           args.threads, devices[0])
        for sr, regs in records:
            res_regs_out(out, index, mo, sr.rec, regs, sr.rep_len,
                         is_sam, rg_id, 0, 1, [regs])
    timeline.mark("mapping done")
    gmet.report(args.verbose)
    return 0


def _run_gpu_multihost(args, index, mo, rg_id, is_sam, sam_header,
                       device) -> int:
    """One rank of a multi-process run (the JAX package's
    _run_tpu_multihost, cli.py:755-808): this process maps its
    round-robin share of the reads and writes OUT.shard<rank> plus an
    .idx sidecar of (file_ordinal, global_read_idx, n_lines) records, a
    `#file <ordinal> <records seen>` line per query file and a closing
    `#done <n_records>`; tools/mergeshards.py merges the shards into the
    single-process byte order.  SAM: rank 0 carries the header as a
    sort-first (-1, -1) idx record.  --tpu-coord first joins the ranks'
    torch.distributed rendezvous (parallel.mesh.init_distributed), left
    once the shard is written."""
    import io as _io

    import torch

    from mm2_gb_tpu_torch.models.pipeline import (GpuMetrics,
                                                  map_file_gpu_records)
    from mm2_gb_tpu_torch.parallel import mesh
    from mm2_gb_tpu_torch.utils.gpucfg import derive_caps
    if not args.output or args.output == "-":
        sys.stderr.write("[ERROR] --tpu-nproc needs -o OUT (shard "
                         "prefix).\n")
        return 1
    rank, nproc = args.tpu_rank, args.tpu_nproc
    if args.tpu_coord:
        mesh.init_distributed(args.tpu_coord, nproc, rank)
    try:
        if device.type == "cuda":   # the kernels launch on the current card
            torch.cuda.set_device(device)
        derive_caps(device, args.verbose)
        gmet = GpuMetrics()
        shard_path = f"{args.output}.shard{rank}"
        n_rec = 0
        with open(shard_path, "w") as sh_out, \
                open(shard_path + ".idx", "w") as idx_out:
            if is_sam and rank == 0 and sam_header:
                sh_out.write(sam_header)
                idx_out.write(f"-1\t-1\t{sam_header.count(chr(10))}\n")
                n_rec += 1
            for fi, q in enumerate(args.query):
                scanned0 = gmet.n_scanned
                for sr, regs in map_file_gpu_records(
                        index, mo, [q], gmet, args.threads, device,
                        (rank, nproc)):
                    buf = _io.StringIO()
                    res_regs_out(buf, index, mo, sr.rec, regs, sr.rep_len,
                                 is_sam, rg_id, 0, 1, [regs])
                    text = buf.getvalue()
                    sh_out.write(text)
                    idx_out.write(f"{fi}\t{sr.rec.rid}\t"
                                  f"{text.count(chr(10))}\n")
                    n_rec += 1
                # every record this rank saw in the file, owned or not: the
                # merge detects trailing losses on any rank from it
                idx_out.write(f"#file\t{fi}\t{gmet.n_scanned - scanned0}\n")
            idx_out.write(f"#done\t{n_rec}\n")
    finally:
        mesh.shutdown_distributed()
    gmet.report(args.verbose)
    return 0


def rc_record(rec):
    """Reverse-complemented copy of a read (mm_revcomp_bseq, bseq.h:46-57)."""
    from mm2_gb_tpu_torch.utils.fastx import SeqRecord
    from mm2_gb_tpu_torch.utils.sam import _revcomp_str
    return SeqRecord(rec.rid, rec.name, _revcomp_str(rec.seq),
                     rec.qual[::-1] if rec.qual else None, rec.comment)


def _qname_same(a: str, b: str) -> bool:
    from mm2_gb_tpu_torch.utils.sam import _qname_len
    la, lb = _qname_len(a), _qname_len(b)
    return la == lb and a[:la] == b[:lb]


def res_regs_out(out, index, mo, rec, regs, rep_len, is_sam, rg_id,
                 seg_idx, n_seg, seg_regs) -> None:
    """Write one read's records, in an `output.read` span."""
    from mm2_gb_tpu_torch.utils.paf import write_paf
    from mm2_gb_tpu_torch.utils.sam import write_sam_record
    with timeline.span("output.read"):
        if regs:
            for j, r in enumerate(regs):
                if (mo.flag & O.MM_F_NO_PRINT_2ND) and r.id != r.parent:
                    continue
                if is_sam:
                    out.write(write_sam_record(
                        index, rec, j, regs, mo.flag, rep_len, rg_id,
                        seg_idx, n_seg, seg_regs) + "\n")
                else:
                    out.write(write_paf(r, rec.name, rec.length, index,
                                        mo.flag, rep_len, rec.comment,
                                        rec.seq) + "\n")
        elif is_sam and not (mo.flag & O.MM_F_SAM_HIT_ONLY):
            out.write(write_sam_record(index, rec, -1, regs, mo.flag,
                                       rep_len, rg_id, seg_idx, n_seg,
                                       seg_regs) + "\n")
        elif (mo.flag & O.MM_F_PAF_NO_HIT) and not is_sam:
            out.write(write_paf(None, rec.name, rec.length, index,
                                mo.flag, rep_len) + "\n")


if __name__ == "__main__":
    sys.exit(main())
