# Frozen copy of mm2_gb_tpu_torch/utils/opts.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""Indexing and mapping options, presets, validation and calibration.

Mirrors the three-tier config system of the reference (SURVEY.md §5.6):
presets applied first, explicit flags second, and device (batch/kernel)
config third.  Defaults reproduce options.c:5-66; presets options.c:90-164;
validation options.c:166-236; index calibration options.c:68-82.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# mapping flags (minimap.h:8-44); kept as an int bitset for CLI parity
MM_F_NO_DIAG = 0x001
MM_F_NO_DUAL = 0x002
MM_F_CIGAR = 0x004
MM_F_OUT_SAM = 0x008
MM_F_NO_QUAL = 0x010
MM_F_OUT_CG = 0x020
MM_F_OUT_CS = 0x040
MM_F_SPLICE = 0x080
MM_F_SPLICE_FOR = 0x100
MM_F_SPLICE_REV = 0x200
MM_F_NO_LJOIN = 0x400
MM_F_OUT_CS_LONG = 0x800
MM_F_SR = 0x1000
MM_F_FRAG_MODE = 0x2000
MM_F_NO_PRINT_2ND = 0x4000
MM_F_2_IO_THREADS = 0x8000
MM_F_LONG_CIGAR = 0x10000
MM_F_INDEPEND_SEG = 0x20000
MM_F_SPLICE_FLANK = 0x40000
MM_F_SOFTCLIP = 0x80000
MM_F_FOR_ONLY = 0x100000
MM_F_REV_ONLY = 0x200000
MM_F_HEAP_SORT = 0x400000
MM_F_ALL_CHAINS = 0x800000
MM_F_OUT_MD = 0x1000000
MM_F_COPY_COMMENT = 0x2000000
MM_F_EQX = 0x4000000
MM_F_PAF_NO_HIT = 0x8000000
MM_F_NO_END_FLT = 0x10000000
MM_F_HARD_MLEVEL = 0x20000000
MM_F_SAM_HIT_ONLY = 0x40000000
MM_F_RMQ = 0x80000000
MM_F_QSTRAND = 0x100000000
MM_F_NO_INV = 0x200000000
MM_F_NO_HASH_NAME = 0x400000000
MM_F_TPU_CHAIN = 0x800000000  # analog of MM_F_GPU_CHAIN: chain on the TPU
MM_F_TPU_ALIGN = 0x1000000000  # gap-fill extension DP on the TPU (ksw2_tpu)

# index flags
MM_I_HPC = 0x1
MM_I_NO_SEQ = 0x2
MM_I_NO_NAME = 0x4

MM_MAX_SEG = 255


@dataclass
class IndexOptions:
    """Reference: mm_idxopt_t (minimap.h) with defaults of options.c:5-12."""
    k: int = 15
    w: int = 10
    flag: int = 0
    bucket_bits: int = 14          # kept for dump/load parity; our index is a sorted table
    mini_batch_size: int = 50_000_000
    batch_size: int = 4_000_000_000


@dataclass
class MapOptions:
    """Reference: mm_mapopt_t (minimap.h) with defaults of options.c:14-66."""
    flag: int = 0
    seed: int = 11
    # seeding
    mid_occ_frac: float = 2e-4
    min_mid_occ: int = 10
    max_mid_occ: int = 1_000_000
    sdust_thres: int = 0
    q_occ_frac: float = 0.01
    mid_occ: int = 0
    max_occ: int = 0
    max_max_occ: int = 4095
    occ_dist: int = 500
    # chaining
    min_cnt: int = 3
    min_chain_score: int = 40
    bw: int = 500
    bw_long: int = 20000
    max_gap: int = 5000
    max_gap_ref: int = -1
    max_frag_len: int = 0
    max_chain_skip: int = 25
    max_chain_iter: int = 5000
    rmq_inner_dist: int = 1000
    rmq_size_cap: int = 100_000
    rmq_rescue_size: int = 1000
    rmq_rescue_ratio: float = 0.1
    chain_gap_scale: float = 0.8
    chain_skip_scale: float = 0.0
    # primary/secondary selection
    mask_level: float = 0.5
    mask_len: int = 2**31 - 1
    pri_ratio: float = 0.8
    best_n: int = 5
    alt_drop: float = 0.15
    # alignment scoring
    a: int = 2
    b: int = 4
    q: int = 4
    e: int = 2
    q2: int = 24
    e2: int = 1
    sc_ambi: int = 1
    noncan: int = 0
    junc_bonus: int = 0
    zdrop: int = 400
    zdrop_inv: int = 200
    end_bonus: int = -1
    min_dp_max: int = 80           # min_chain_score * a
    min_ksw_len: int = 200
    anchor_ext_len: int = 20
    anchor_ext_shift: int = 6
    max_clip_ratio: float = 1.0
    rank_min_len: int = 500
    rank_frac: float = 0.9
    # paired-end
    pe_ori: int = 0
    pe_bonus: int = 33
    # batching / runtime
    max_qlen: int = 0
    mini_batch_size: int = 500_000_000
    max_sw_mat: int = 100_000_000
    cap_kalloc: int = 1_000_000_000
    split_prefix: str | None = None
    # debug dumps (mm_dbg_flag analog; --print-seeds / --print-chains /
    # --print-qname / --print-aln-seq)
    dbg_print_seed: bool = False
    dbg_print_chain: bool = False
    dbg_print_qname: bool = False
    dbg_print_aln_seq: bool = False
    # device (TPU) chaining config — analog of the reference's GPU JSON tier
    tpu_config_file: str = ""


def set_preset(preset: str | None) -> tuple[IndexOptions, MapOptions]:
    """Build (IndexOptions, MapOptions) for a named preset (options.c:90-164).

    Must be called BEFORE applying explicit CLI overrides, matching the
    reference's two-pass option parsing (main.c:146-160).
    """
    io = IndexOptions()
    mo = MapOptions()
    if preset is None or preset == "map-ont":
        pass
    elif preset == "ava-ont":
        io.flag, io.k, io.w = 0, 15, 5
        mo.flag |= MM_F_ALL_CHAINS | MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_NO_LJOIN
        mo.min_chain_score, mo.pri_ratio, mo.max_chain_skip = 100, 0.0, 25
        mo.bw = mo.bw_long = 2000
        mo.occ_dist = 0
    elif preset in ("map10k", "map-pb"):
        io.flag |= MM_I_HPC
        io.k = 19
    elif preset == "ava-pb":
        io.flag |= MM_I_HPC
        io.k, io.w = 19, 5
        mo.flag |= MM_F_ALL_CHAINS | MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_NO_LJOIN
        mo.min_chain_score, mo.pri_ratio, mo.max_chain_skip = 100, 0.0, 25
        mo.bw_long = mo.bw
        mo.occ_dist = 0
    elif preset in ("map-hifi", "map-ccs"):
        io.flag, io.k, io.w = 0, 19, 19
        mo.max_gap = 10000
        mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 4, 6, 26, 2, 1
        mo.occ_dist = 500
        mo.min_mid_occ, mo.max_mid_occ = 50, 500
        mo.min_dp_max = 200
    elif preset.startswith("asm"):
        io.flag, io.k, io.w = 0, 19, 19
        mo.bw, mo.bw_long = 1000, 100_000
        mo.max_gap = 10000
        mo.flag |= MM_F_RMQ
        mo.min_mid_occ, mo.max_mid_occ = 50, 500
        mo.min_dp_max = 200
        mo.best_n = 50
        if preset == "asm5":
            mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 19, 39, 81, 3, 1
            mo.zdrop = mo.zdrop_inv = 200
        elif preset == "asm10":
            mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 9, 16, 41, 2, 1
            mo.zdrop = mo.zdrop_inv = 200
        elif preset == "asm20":
            mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 4, 6, 26, 2, 1
            mo.zdrop = mo.zdrop_inv = 200
            io.w = 10
        else:
            raise ValueError(f"unknown preset: {preset}")
    elif preset in ("short", "sr"):
        io.flag, io.k, io.w = 0, 21, 11
        mo.flag |= (MM_F_SR | MM_F_FRAG_MODE | MM_F_NO_PRINT_2ND
                    | MM_F_2_IO_THREADS | MM_F_HEAP_SORT)
        mo.pe_ori = 0 << 1 | 1  # FR
        mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 2, 8, 12, 2, 24, 1
        mo.zdrop = mo.zdrop_inv = 100
        mo.end_bonus = 10
        mo.max_frag_len = 800
        mo.max_gap = 100
        mo.bw = mo.bw_long = 100
        mo.pri_ratio = 0.5
        mo.min_cnt = 2
        mo.min_chain_score = 25
        mo.min_dp_max = 40
        mo.best_n = 20
        mo.mid_occ = 1000
        mo.max_occ = 5000
        mo.mini_batch_size = 50_000_000
    elif preset.startswith("splice") or preset == "cdna":
        io.flag, io.k, io.w = 0, 15, 5
        mo.flag |= MM_F_SPLICE | MM_F_SPLICE_FOR | MM_F_SPLICE_REV | MM_F_SPLICE_FLANK
        mo.max_sw_mat = 0
        mo.max_gap = 2000
        mo.max_gap_ref = mo.bw = mo.bw_long = 200_000
        mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 1, 2, 2, 1, 32, 0
        mo.noncan = 9
        mo.junc_bonus = 9
        mo.zdrop, mo.zdrop_inv = 200, 100
        if preset == "splice:hq":
            mo.junc_bonus, mo.b, mo.q, mo.q2 = 5, 4, 6, 24
    else:
        raise ValueError(f"unknown preset: {preset}")
    return io, mo


def mapopt_update(mo: MapOptions, index) -> None:
    """Calibrate mid_occ from the index occurrence distribution (options.c:68-82)."""
    if (mo.flag & MM_F_SPLICE_FOR) or (mo.flag & MM_F_SPLICE_REV):
        mo.flag |= MM_F_SPLICE
    if mo.mid_occ <= 0:
        mo.mid_occ = index.cal_max_occ(mo.mid_occ_frac)
        if mo.mid_occ < mo.min_mid_occ:
            mo.mid_occ = mo.min_mid_occ
        if mo.max_mid_occ > mo.min_mid_occ and mo.mid_occ > mo.max_mid_occ:
            mo.mid_occ = mo.max_mid_occ
    if mo.bw_long < mo.bw:
        mo.bw_long = mo.bw


def check_opt(io: IndexOptions, mo: MapOptions) -> None:
    """Validate option combinations (options.c:166-236); raises ValueError."""
    if mo.bw > mo.bw_long:
        raise ValueError("with '-rNUM1,NUM2', NUM1 can't be larger than NUM2")
    if (mo.flag & MM_F_RMQ) and (mo.flag & (MM_F_SR | MM_F_SPLICE)):
        raise ValueError("--rmq doesn't work with --sr or --splice")
    if io.k <= 0 or io.w <= 0:
        raise ValueError("-k and -w must be positive")
    if mo.best_n < 0:
        raise ValueError("-N must be no less than 0")
    if not (0.0 <= mo.pri_ratio <= 1.0):
        raise ValueError("-p must be within 0 and 1")
    if (mo.flag & MM_F_FOR_ONLY) and (mo.flag & MM_F_REV_ONLY):
        raise ValueError("--for-only and --rev-only are mutually exclusive")
    if mo.e <= 0 or mo.q <= 0:
        raise ValueError("-O and -E must be positive")
    if (mo.q != mo.q2 or mo.e != mo.e2) and not (mo.e > mo.e2 and mo.q + mo.e < mo.q2 + mo.e2):
        raise ValueError("dual gap penalties violating E1>E2 and O1+E1<O2+E2")
    if (mo.q + mo.e) + (mo.q2 + mo.e2) > 127:
        raise ValueError("scoring system violating ({-O}+{-E})+({-O2}+{-E2}) <= 127")
    if mo.zdrop < mo.zdrop_inv:
        raise ValueError("Z-drop should not be less than inversion-Z-drop")
    if (mo.flag & MM_F_NO_PRINT_2ND) and (mo.flag & MM_F_ALL_CHAINS):
        raise ValueError("-X/-P and --secondary=no are mutually exclusive")
    if (mo.flag & MM_F_QSTRAND) and (
            (mo.flag & (MM_F_OUT_SAM | MM_F_SPLICE | MM_F_FRAG_MODE))
            or (io.flag & MM_I_HPC)):  # options.c:230-234
        raise ValueError("--qstrand doesn't work with -a, -H, --frag "
                         "or --splice")
