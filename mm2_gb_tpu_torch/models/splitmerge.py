"""Multi-part index mapping + split merge (splitidx.c, map.c:1205-1268).

Large references are indexed in <= batch_size parts; queries map against
every part, per-part hits spill to temp files (--split-prefix) or stay in
memory, and a merge pass re-ranks the union per read: rid shift, optional
divergence re-ranking, hit_sort, set_parent, select_sub, SAM-primary,
MAPQ and PE pairing (merge_hits, map.c:1225-1263).
"""

from __future__ import annotations

import os
import pickle
import sys

from mm2_gb_tpu_torch.models import hit as hitmod
from mm2_gb_tpu_torch.models import pe as pemod
from mm2_gb_tpu_torch.models.index import MinimizerIndex, from_fasta_parts
from mm2_gb_tpu_torch.models.stream import Metrics, _map_one, read_frag_batches
from mm2_gb_tpu_torch.utils import opts as O


def _zero_region(with_extra: bool) -> hitmod.Region:
    """A calloc'd mm_reg1_t (merge_hits reads one per stale n_reg after
    the dump file hits EOF; fread leaves the zeroed struct untouched,
    map.c:1237-1244 + misc.c:155-163 which only aborts on ret == EOF,
    never on a short read).  With MM_F_CIGAR the reference then assigns
    a zeroed mm_extra_t whose fread also fails."""
    r = hitmod.Region(parent=0, div=0.0)
    if with_extra:
        r.p = hitmod.AlnExtra()
    return r


def map_multipart(target: str, paths: list[str], io, mo, out,
                  batch_size: int, split_prefix: str | None,
                  rg: str | None, cli_args, verbose: int = 1,
                  threads: int = 3, device="cuda") -> int:
    """Map against every part of the index.  With MM_F_TPU_CHAIN (one
    single-segment query file; the callers clear it otherwise) each part
    maps through the device pipeline on `device`."""
    from mm2_gb_tpu_torch.cli import res_regs_out
    from mm2_gb_tpu_torch.ops import align as align_ops

    is_sam = bool(mo.flag & O.MM_F_OUT_SAM)
    if not split_prefix:
        # Without --split-prefix there is NO merge: queries map against
        # each part independently and print as they go (main.c:404-462
        # index-reader loop).  For SAM, @SQ lines are suppressed when
        # more parts follow (mm_write_sam_hdr(0,...), main.c:418-421).
        from mm2_gb_tpu_torch.models.index import from_fasta_parts2
        from mm2_gb_tpu_torch.models.stream import map_file_stream
        from mm2_gb_tpu_torch.utils.sam import PG_VN, write_sam_header
        rg_id = None
        n_parts = 0
        for index, is_last in from_fasta_parts2(target, io, batch_size):
            O.mapopt_update(mo, index)
            if n_parts == 0 and is_sam:
                if rg:
                    rg = rg.replace("\\t", "\t")
                    rg_id = next((f[3:] for f in rg.split("\t")
                                  if f.startswith("ID:")), None)
                out.write(write_sam_header(index if is_last else None,
                                           rg, PG_VN, cli_args)
                          + "\n")
                if not is_last and verbose >= 2:
                    sys.stderr.write(
                        "[WARNING] For a multi-part index, no @SQ lines "
                        "will be outputted. Please use --split-prefix.\n")
            if (mo.flag & O.MM_F_TPU_CHAIN) and len(paths) == 1 \
                    and not (mo.flag & O.MM_F_FRAG_MODE):
                from mm2_gb_tpu_torch.models.pipeline import \
                    map_file_gpu_records
                for sr, regs in map_file_gpu_records(index, mo, paths,
                                                     device=device):
                    res_regs_out(out, index, mo, sr.rec, regs, sr.rep_len,
                                 is_sam, rg_id, 0, 1, [regs])
            else:
                map_file_stream(index, mo, paths, out, threads, rg_id)
            n_parts += 1
        return 0 if n_parts else 1

    parts_meta = []      # (names, lens) per part
    part_results = []    # per part: flat per-READ dumps (regs, rep_len,
    #                      frag_gap) in mapping-pass order — the exact
    #                      granularity of the reference tmp files
    #                      (map.c:1343-1354 writes one record per read)
    tmp_files = []

    # mm_map_file re-opens prefix.<part>.tmp with "wb" per query file
    # (map.c:1423 → splitidx.c:14-15), so with >=2 non-frag query files
    # each call TRUNCATES the previous file's dumps: only the LAST query
    # file's records survive per part.  Mapping the earlier files would
    # produce output the truncation then discards — skip them outright.
    map_paths = paths
    if len(paths) > 1 and not (mo.flag & O.MM_F_FRAG_MODE):
        map_paths = [paths[-1]]

    n_parts = 0
    for index in from_fasta_parts(target, io, batch_size):
        O.mapopt_update(mo, index)
        if verbose >= 3:
            sys.stderr.write(f"[M::split] mapping against part {n_parts} "
                             f"({index.n_seq} sequences)\n")
        results = []
        if (mo.flag & O.MM_F_TPU_CHAIN) and len(map_paths) == 1 \
                and not (mo.flag & O.MM_F_FRAG_MODE):
            # per-part device mapping (beyond the reference GPU path,
            # which is single-index only, plchain.cu:499): each part runs
            # the full device pipeline; the merge pass is unchanged
            from mm2_gb_tpu_torch.models.mapper import _chain_gaps
            from mm2_gb_tpu_torch.models.pipeline import map_file_gpu_records
            for sr, regs in map_file_gpu_records(index, mo, map_paths,
                                                 device=device):
                frag_gap = _chain_gaps(mo, sr.rec.length)[1]
                results.append((regs, sr.rep_len, frag_gap))
        else:
            for batch in read_frag_batches(map_paths, mo,
                                           mo.mini_batch_size, Metrics()):
                for frag in batch:
                    seg_regs, rep_lens, frag_gap = _map_one(index, mo, frag)
                    for s in range(len(frag)):
                        results.append((seg_regs[s], rep_lens[s], frag_gap))
        parts_meta.append((index.names, index.lens))
        if split_prefix:
            fn = f"{split_prefix}.{n_parts:04d}.tmp"
            with open(fn, "wb") as f:
                pickle.dump(results, f)
            tmp_files.append(fn)
            part_results.append(None)
        else:
            part_results.append(results)
        n_parts += 1

    if n_parts == 0:
        return 1
    if split_prefix:
        part_results = []
        for fn in tmp_files:
            with open(fn, "rb") as f:
                part_results.append(pickle.load(f))

    # merged sequence table + rid shifts
    rid_shift = [0]
    all_names: list[str] = []
    all_lens: list[int] = []
    for names, lens in parts_meta:
        all_names.extend(names)
        all_lens.extend(int(v) for v in lens)
        rid_shift.append(rid_shift[-1] + len(names))

    class MergedIndex:
        pass

    import numpy as np
    merged = MergedIndex()
    merged.names = all_names
    merged.lens = np.array(all_lens, np.uint32)
    merged.n_seq = len(all_names)
    merged.k = io.k

    is_sam = bool(mo.flag & O.MM_F_OUT_SAM)
    rg_id = None
    if is_sam:
        from mm2_gb_tpu_torch.utils.sam import PG_VN, write_sam_header
        if rg:  # -R forwarded through the multipart path (main.c:196)
            rg = rg.replace("\\t", "\t")
            rg_id = next((f[3:] for f in rg.split("\t")
                          if f.startswith("ID:")), None)
        # split-prefix order: @RG/@PG first without @SQ (main.c:415-417),
        # @SQ lines printed by the merge pass (mm_split_merge,
        # map.c:1466-1468)
        out.write(write_sam_header(None, rg, PG_VN, cli_args) + "\n")
        for i in range(merged.n_seq):
            out.write(f"@SQ\tSN:{merged.names[i]}"
                      f"\tLN:{int(merged.lens[i])}\n")

    # The merge re-read always interleaves multiple query files with
    # qname grouping (mm_split_merge opens all files, map.c:1448-1449;
    # frag_mode = n_fp > 1, map.c:1277) and consumes the per-read dumps
    # with a flat cursor (merge_hits, map.c:1219-1246) — with >=2
    # non-frag query files this pairs interleaved records with
    # file-major dumps, a reference quirk the byte contract inherits.
    frag_iter = read_frag_batches(paths, mo, mo.mini_batch_size, Metrics())
    with_cigar = bool(mo.flag & O.MM_F_CIGAR)
    fi = 0  # flat per-read dump cursor (merge_hits' k; fp offsets persist
    #         across batches — only the stale arrays are re-calloc'd)
    for batch in frag_iter:
        # merge_hits callocs n_reg_part/rep_len_part/frag_gap_part per
        # batch (map.c:1216-1218); past dump EOF an fread is a silent
        # no-op (misc.c:155-163 aborts only on ret == EOF), so the
        # previous record's values persist and the regs stay zeroed
        stale = [(0, 0, 0)] * n_parts
        for frag in batch:
            n_seg = len(frag)
            seg_regs = [[] for _ in range(n_seg)]
            rep_lens = [0] * n_seg
            # mm_pair gets part 0's dumped frag_gap of the LAST segment
            # consumed — the map-time max_chain_gap_ref incl. the
            # max_frag_len branch (map.c:509-513 computed, 1346 dumped,
            # frag_gap_part[0] at map.c:1264 consumed)
            frag_gap = 0
            for s in range(n_seg):
                for pi in range(n_parts):
                    if fi + s < len(part_results[pi]):
                        p_regs, p_replen, p_fg = part_results[pi][fi + s]
                        stale[pi] = (len(p_regs), p_replen, p_fg)
                    else:  # dump EOF (the multi-file truncation quirk)
                        n_stale, p_replen, p_fg = stale[pi]
                        p_regs = [_zero_region(with_cigar)
                                  for _ in range(n_stale)]
                    for r in p_regs:
                        r.rid += rid_shift[pi]
                        seg_regs[s].append(r)
                    rep_lens[s] = max(rep_lens[s], p_replen)
                    if pi == 0:
                        frag_gap = p_fg
            # merge_hits re-ranking (map.c:1247-1260)
            for s in range(n_seg):
                regs = seg_regs[s]
                qlen = frag[s].length
                if not (mo.flag & O.MM_F_SR) and qlen >= mo.rank_min_len:
                    align_ops.update_dp_max(qlen, regs, mo.rank_frac, mo.a,
                                            mo.b)
                for r in regs:
                    if r.p is not None:
                        r.p.dp_max2 = 0
                    r.subsc = 0
                    r.n_sub = 0
                regs = hitmod.hit_sort(regs, mo.alt_drop)
                for i, r in enumerate(regs):
                    r.id = i
                hitmod.set_parent(regs, mo.mask_level, mo.mask_len,
                                  mo.a * 2 + mo.b,
                                  bool(mo.flag & O.MM_F_HARD_MLEVEL),
                                  mo.alt_drop)
                if not (mo.flag & O.MM_F_ALL_CHAINS):
                    regs = hitmod.select_sub(regs, mo.pri_ratio, io.k * 2,
                                             mo.best_n, False,
                                             int(mo.max_gap * 0.8))
                    hitmod.set_sam_pri(regs)
                hitmod.set_mapq(regs, mo.min_chain_score, mo.a, rep_lens[s],
                                bool(mo.flag & O.MM_F_SR))
                seg_regs[s] = regs
            if (n_seg == 2 and mo.pe_ori >= 0
                    and (mo.flag & O.MM_F_CIGAR)):
                pemod.pair(frag_gap, mo.pe_bonus, mo.a * 2 + mo.b, mo.a,
                           [r.length for r in frag], seg_regs)
            for j, rec in enumerate(frag):
                # rl:i is 0 for every merged read: the merge pipeline
                # callocs s->rep_len and never fills it (map.c:1300 vs
                # 1099/1178) — the dumped rep_len max feeds only
                # mm_set_mapq above (map.c:1222-1227,1261)
                res_regs_out(out, merged, mo, rec, seg_regs[j], 0,
                             is_sam, rg_id, j, n_seg, seg_regs)
            fi += n_seg

    for fn in tmp_files:
        os.unlink(fn)
    return 0
