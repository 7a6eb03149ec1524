"""Command-line driver: the minimap2 flag surface, chaining on the GPU.

Usage:
    python -m mm2_gb_tpu_torch [options] <target.fa> <query.fa> [...]
    python -m mm2_gb_tpu_torch --gpu-chain --max-chain-skip=2147483647 \\
        ref.fa reads.fa > out.paf

The parser, the option overrides and the record writer are the JAX
package's (mm2_gb_tpu.cli; none of it imports JAX).  Without --gpu-chain
the run is the JAX package's host path.  With it, this module's `_run`
builds or loads the index and maps through models.pipeline, which
chains on the CUDA device; a run with no CUDA device fails rather than
falling back to the CPU.  --gpu-align (the JAX package's --tpu-align)
adds the gap fills of -c runs on the device.  Multi-part indexes and
fragment mode keep the host chaining routes (with the JAX package's
warnings).
"""

from __future__ import annotations

import sys

from mm2_gb_tpu.cli import apply_overrides, build_parser, res_regs_out
from mm2_gb_tpu.utils import opts as O

# device features of the JAX package that this port does not have yet
# (the --gpu-align routes it lacks are refused in _run, once the options
# are final)
_NOT_PORTED = (
    (lambda a: a.tpu_devices != 1, "--tpu-devices != 1"),
    (lambda a: a.tpu_nproc > 1, "--tpu-nproc > 1"),
    (lambda a: a.tpu_profile is not None, "--tpu-profile"),
)

_MULTIPART_WARNING = ("[WARNING] --tpu-chain with a multi-part index "
                      "supports one single-segment query file; falling "
                      "back to host chaining.\n")


def parse_args(argv: list[str]):
    """(argv, args) as the run sees them: --cs takes an OPTIONAL =fmt
    (main.c:231-236), and --gpu-align is the parser's --tpu-align."""
    argv = ["--cs=short" if a == "--cs" else
            "--tpu-align" if a == "--gpu-align" else a for a in argv]
    return argv, build_parser().parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    from mm2_gb_tpu import cli as host_cli
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if not argv:
        return host_cli.main(argv)   # the reference-style usage block
    argv, args = parse_args(argv)
    for given, flag in _NOT_PORTED:
        if given(args):
            sys.stderr.write(f"[ERROR] {flag} is not yet ported to "
                             "mm2_gb_tpu_torch; use mm2_gb_tpu for it.\n")
            return 1
    try:
        io, mo = O.set_preset(args.preset)
    except ValueError as e:
        sys.stderr.write(f"[ERROR] {e}\n")
        return 1
    if args.tpu_cfg:
        # consumed here: apply_overrides would install it into the TPU
        # chain module (and import JAX)
        from mm2_gb_tpu_torch.utils.gpucfg import (apply_gpu_config,
                                                   load_gpu_config)
        apply_gpu_config(load_gpu_config(args.tpu_cfg))
        args.tpu_cfg = None
    try:
        if not args.tpu_chain:
            return host_cli._run(args, argv, io, mo)
        import torch
        return _run(args, argv, io, mo, torch.device("cuda"))
    except FileNotFoundError as e:  # main.c:414 open-failure message
        sys.stderr.write(f"[ERROR] failed to open file '{e.filename}': "
                         "No such file or directory\n")
        return 1


def _parse_batch_size(s: str) -> int:
    mult = {"k": 10**3, "K": 10**3, "m": 10**6, "M": 10**6,
            "g": 10**9, "G": 10**9}.get(s[-1], 1)
    return int(float(s[:-1] if mult > 1 else s) * mult)


def _run(args, argv, io, mo, device) -> int:
    """The --gpu-chain run (follows mm2_gb_tpu/cli.py:525-752) on
    `device`; a CUDA device must be present."""
    import torch

    from mm2_gb_tpu.models.index import MinimizerIndex, _is_mmi
    from mm2_gb_tpu_torch.models.pipeline import unported_align_route
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
    route = (None if mo.flag & O.MM_F_FRAG_MODE   # chains on the host
             else unported_align_route(mo))
    if route is not None:
        sys.stderr.write(f"[ERROR] {route} is not yet ported to "
                         "mm2_gb_tpu_torch; use mm2_gb_tpu for it.\n")
        return 1
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("[ERROR] --gpu-chain needs a CUDA device and "
                         "PyTorch sees none; run without --gpu-chain "
                         "for the host path.\n")
        return 1
    if args.output and args.output != "-":
        try:
            sys.stdout = open(args.output, "w")
        except OSError as e:
            sys.stderr.write(f"[ERROR] failed to write the output to file "
                             f"'{args.output}': {e.strerror}\n")
            return 1

    if args.dump_index and args.batch_size is not None \
            and not (args.target.endswith(".npz") or _is_mmi(args.target)):
        # -d with -I: successive parts append into one mmi file
        # (main.c:404+)
        from mm2_gb_tpu.models.index import from_fasta_parts, save_mmi_parts
        save_mmi_parts(from_fasta_parts(args.target, io,
                                        _parse_batch_size(args.batch_size)),
                       args.dump_index)
        if not args.query:
            return 0
        args.target = args.dump_index  # map against what was dumped
    if args.query and (args.batch_size is not None
                       or args.split_prefix is not None):
        if not ((mo.flag & O.MM_F_FRAG_MODE) or len(args.query) > 1):
            sys.stderr.write("[ERROR] --gpu-chain with a multi-part index "
                             "(-I/--split-prefix) is not yet ported to "
                             "mm2_gb_tpu_torch; use mm2_gb_tpu for it.\n")
            return 1
        sys.stderr.write(_MULTIPART_WARNING)
        mo.flag &= ~(O.MM_F_TPU_CHAIN | O.MM_F_TPU_ALIGN)
        bs = (_parse_batch_size(args.batch_size)
              if args.batch_size is not None else io.batch_size)
        mo.split_prefix = args.split_prefix
        from mm2_gb_tpu.models.splitmerge import map_multipart
        return map_multipart(args.target, args.query, io, mo, sys.stdout,
                             bs, args.split_prefix, args.rg, argv,
                             args.verbose, args.threads)
    if args.target.endswith(".npz") or _is_mmi(args.target):
        if _is_mmi(args.target) and args.query:
            from mm2_gb_tpu.models.index import load_mmi_parts
            it = load_mmi_parts(args.target)
            index = next(it, None)
            if index is None:
                sys.stderr.write(f"[ERROR] failed to read the index "
                                 f"'{args.target}'.\n")
                return 1
            if next(it, None) is not None:
                from mm2_gb_tpu.models.splitmerge import map_multipart
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
        index = MinimizerIndex.from_fasta(args.target, io)
    if args.dump_index:
        index.save(args.dump_index)
        if not args.query:
            return 0
    if args.junc_bed:
        from mm2_gb_tpu.models.index import read_junc_bed
        read_junc_bed(index, args.junc_bed, True)
    if args.alt_list:
        from mm2_gb_tpu.models.index import read_alt_list
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
    if mo.flag & O.MM_F_FRAG_MODE:
        # the reference's GPU path is single-segment only
        # (plchain.cu:499): chain multi-segment fragments on the host
        sys.stderr.write("[WARNING] --tpu-chain supports single-segment "
                         "reads only; falling back to host chaining.\n")
        mo.flag &= ~(O.MM_F_TPU_CHAIN | O.MM_F_TPU_ALIGN)
    if is_sam:
        from mm2_gb_tpu.utils.sam import PG_VN, write_sam_header
        if args.rg:
            rg = args.rg.replace("\\t", "\t")
            rg_id = next((f[3:] for f in rg.split("\t")
                          if f.startswith("ID:")), None)
        out.write(write_sam_header(index, args.rg, PG_VN, argv) + "\n")
    if not (mo.flag & O.MM_F_TPU_CHAIN):
        from mm2_gb_tpu.models.stream import Metrics, map_file_stream
        metrics = Metrics()
        map_file_stream(index, mo, args.query, out, args.threads, rg_id,
                        metrics)
        metrics.report(args.verbose)
        return 0

    from mm2_gb_tpu_torch.models.pipeline import (GpuMetrics,
                                                  map_file_gpu_records)
    from mm2_gb_tpu_torch.utils.gpucfg import derive_caps
    derive_caps(device, args.verbose)
    gmet = GpuMetrics()
    for q in args.query:  # per-file sequential (main.c:451-455)
        for sr, regs in map_file_gpu_records(index, mo, [q], gmet,
                                             args.threads, device):
            res_regs_out(out, index, mo, sr.rec, regs, sr.rep_len,
                         is_sam, rg_id, 0, 1, [regs])
    gmet.report(args.verbose)
    return 0


if __name__ == "__main__":
    sys.exit(main())
