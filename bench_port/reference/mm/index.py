# Frozen copy of mm2_gb_tpu_torch/models/index.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""Minimizer index: sorted-table design.

Replaces the reference's bucketed khash index (index.c:27-98) with a
TPU/vector-friendly layout: one sorted array of (minimizer_hash, packed
position) entries searched with vectorized binary search.  Lookup results
are identical to the reference — per hash, hits come out sorted ascending
by packed position (the reference sorts its p[] arrays the same way,
index.c:253).

Packed position value (same encoding as the reference's index entries):
    pos_val = rid << 32 | last_base_pos << 1 | strand

The index also retains the reference sequences as 2-bit-capable uint8 code
arrays (A=0 C=1 G=2 T=3, ambiguous=4) for the alignment stage — equivalent
to the reference's 4-bit packed mm_idx_t::S.
"""

from __future__ import annotations

import gzip

import numpy as np

from .sketch import sketch, _NT4
from .fastx import SeqRecord, read_fastx
from .opts import IndexOptions, MM_I_HPC, MM_I_NO_SEQ

INDEX_FORMAT_VERSION = 1


class MinimizerIndex:
    """Immutable minimizer index over a set of reference sequences."""

    def __init__(self, k: int, w: int, flag: int, names: list[str],
                 lens: np.ndarray, offsets: np.ndarray, seq_codes: np.ndarray,
                 occ_hash: np.ndarray, occ_pos: np.ndarray,
                 index_id: int = 0):
        self.k = k
        self.w = w
        self.flag = flag
        self.names = names                  # per-rid sequence names
        self.lens = lens                    # uint32 per-rid lengths
        self.offsets = offsets              # uint64 per-rid offset into seq_codes
        self.seq_codes = seq_codes          # uint8 concatenated base codes
        self.occ_hash = occ_hash            # uint64 sorted minimizer hashes (one per hit)
        self.occ_pos = occ_pos              # uint64 packed positions, grouped by hash
        self.index_id = index_id            # multi-part index ordinal
        self.n_seq = len(names)
        self.n_alt = 0
        self.alt_mask = np.zeros(self.n_seq, dtype=bool)

    # ---------------------------------------------------------------- build
    @classmethod
    def build(cls, records: list[SeqRecord], opts: IndexOptions,
              index_id: int = 0) -> "MinimizerIndex":
        names = [r.name for r in records]
        lens = np.array([r.length for r in records], dtype=np.uint32)
        offsets = np.zeros(len(records), dtype=np.uint64)
        total = 0
        for i, r in enumerate(records):
            offsets[i] = total
            total += r.length
        seq_codes = np.empty(total, dtype=np.uint8)
        for i, r in enumerate(records):
            raw = r.seq.encode() if isinstance(r.seq, str) else r.seq
            seq_codes[int(offsets[i]):int(offsets[i]) + r.length] = \
                _NT4[np.frombuffer(raw, dtype=np.uint8)]

        chunks = []
        is_hpc = bool(opts.flag & MM_I_HPC)
        for i, r in enumerate(records):
            if r.length == 0:
                continue
            mm = sketch(r.seq, opts.w, opts.k, i, is_hpc)
            if mm.shape[0]:
                chunks.append(mm)
        if chunks:
            allmm = np.concatenate(chunks)
            # key = hash only (span excluded), exactly like the reference's
            # bucket hash key (index.c:240 groups by x>>8)
            h = allmm[:, 0] >> np.uint64(8)
            pos = allmm[:, 1]
            order = np.lexsort((pos, h))
            occ_hash = np.ascontiguousarray(h[order])
            occ_pos = np.ascontiguousarray(pos[order])
        else:
            occ_hash = np.empty(0, dtype=np.uint64)
            occ_pos = np.empty(0, dtype=np.uint64)
        return cls(opts.k, opts.w, opts.flag, names, lens, offsets, seq_codes,
                   occ_hash, occ_pos, index_id)

    @classmethod
    def from_fasta(cls, path: str, opts: IndexOptions | None = None) -> "MinimizerIndex":
        opts = opts or IndexOptions()
        return cls.build(list(read_fastx(path)), opts)

    @classmethod
    def from_strings(cls, seqs: list[str], opts: IndexOptions | None = None,
                     names: list[str] | None = None) -> "MinimizerIndex":
        """mm_idx_str analog (index.c:409-457)."""
        opts = opts or IndexOptions()
        recs = [SeqRecord(rid=i, name=(names[i] if names else str(i)), seq=s)
                for i, s in enumerate(seqs)]
        return cls.build(recs, opts)

    # --------------------------------------------------------------- lookup
    def _lut(self):
        """Unique-minimizer lookup tables, built lazily on first use:
        (uniq hashes, first-occurrence offset, occurrence count) plus a
        bucket-offset table over the hash's top bits — the sorted-array
        equivalent of the reference's 2^b hash buckets (index.c:27-32)."""
        lut = getattr(self, "_lut_cache", None)
        if lut is None:
            uniq, start, cnt = np.unique(self.occ_hash, return_index=True,
                                         return_counts=True)
            start = start.astype(np.int64)
            cnt = cnt.astype(np.int64)
            if uniq.shape[0]:
                # ~0.5 keys per bucket so a lookup is one probe, not a
                # cache-missing binary search; capped at 2^24 buckets
                # (128 MB offsets) for huge references
                bits = min(24, max(14, int(uniq.shape[0]).bit_length() + 1))
                shift = max(int(uniq[-1]).bit_length() - bits, 0)
                n_buckets = (int(uniq[-1]) >> shift) + 1
                edges = (np.arange(n_buckets + 1, dtype=np.uint64)
                         << np.uint64(shift))
                boff = np.searchsorted(uniq, edges).astype(np.int64)
            else:
                shift, n_buckets = 0, 0
                boff = np.zeros(1, np.int64)
            lut = (uniq, start, cnt, boff, n_buckets, shift)
            self._lut_cache = lut
        return lut

    def lookup(self, qhashes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized point lookup (mm_idx_get analog, index.c:81-98).

        `qhashes` are raw minimizer hashes (x >> 8 of sketch output).
        Returns (start, count) int64 arrays into self.occ_pos.
        """
        from . import native
        q = np.ascontiguousarray(qhashes, dtype=np.uint64)
        uniq, start, cnt, boff, n_buckets, shift = self._lut()
        if uniq.shape[0] == 0:
            z = np.zeros(q.shape[0], np.int64)
            return z, z.copy()
        if native.available():
            return native.idx_lookup(uniq, start, cnt, boff, n_buckets,
                                     shift, q)
        idx = np.searchsorted(uniq, q)
        idx_c = np.minimum(idx, uniq.shape[0] - 1)
        found = uniq[idx_c] == q
        return (np.where(found, start[idx_c], 0),
                np.where(found, cnt[idx_c], 0))

    def cal_max_occ(self, frac: float) -> int:
        """Occurrence threshold at quantile 1-frac (index.c:186-207)."""
        if frac <= 0.0 or self.occ_hash.shape[0] == 0:
            return 2**31 - 1
        counts = self._lut()[2]
        n = counts.shape[0]
        kk = int((1.0 - frac) * n)
        if kk >= n:
            kk = n - 1
        return int(np.partition(counts.astype(np.uint32), kk)[kk]) + 1

    # ------------------------------------------------------------ sequences
    def get_seq(self, rid: int, st: int, en: int, rev: bool = False) -> np.ndarray:
        """Base codes of reference rid in [st, en).

        With rev=True, [st, en) are coordinates ON THE REVERSE STRAND
        (mm_idx_getseq_rev, index.c:165-177): fetch forward
        [len-en, len-st) and reverse-complement.  Used by the qstrand
        mode, where minus-strand anchors carry flipped target coords.
        """
        off = int(self.offsets[rid])
        if rev:
            length = int(self.lens[rid])
            en = min(en, length)
            s = self.seq_codes[off + length - en: off + length - st]
            return np.where(s < 4, 3 - s, s)[::-1]
        return self.seq_codes[off + st: off + en]

    # ----------------------------------------------------------------- dump
    def save(self, path: str) -> None:
        if path.endswith(".mmi"):
            _save_mmi(self, path)
            return
        np.savez_compressed(
            path,
            version=np.int32(INDEX_FORMAT_VERSION),
            k=np.int32(self.k), w=np.int32(self.w), flag=np.int32(self.flag),
            names=np.array(self.names, dtype=object),
            lens=self.lens, offsets=self.offsets, seq_codes=self.seq_codes,
            occ_hash=self.occ_hash, occ_pos=self.occ_pos,
        )

    @classmethod
    def load(cls, path: str) -> "MinimizerIndex":
        if path.endswith(".mmi") or _is_mmi(path):
            return _load_mmi(path)
        z = np.load(path, allow_pickle=True)
        return cls(int(z["k"]), int(z["w"]), int(z["flag"]),
                   [str(n) for n in z["names"]], z["lens"], z["offsets"],
                   z["seq_codes"], z["occ_hash"], z["occ_pos"])

    def stats(self) -> dict:
        uniq, counts = (np.unique(self.occ_hash, return_counts=True)
                        if self.occ_hash.size else (np.empty(0), np.empty(0)))
        return {
            "n_seq": self.n_seq,
            "total_len": int(self.lens.sum()) if self.n_seq else 0,
            "distinct_minimizers": int(uniq.shape[0]),
            "total_occurrences": int(self.occ_hash.shape[0]),
            "singleton_frac": float((counts == 1).mean()) if uniq.size else 0.0,
        }


MMI_MAGIC = b"MMI\x02"


def _is_mmi(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == MMI_MAGIC
    except OSError:
        return False


def _load_mmi(path: str) -> "MinimizerIndex":
    """First part of an .mmi file (mm_idx_load, index.c:504-557)."""
    with open(path, "rb") as f:
        idx = _load_mmi_part(f)
        if idx is None:
            raise ValueError(f"{path}: not an .mmi index")
        return idx


def load_mmi_parts(path: str):
    """Yield successive index parts from a (possibly multi-part) .mmi:
    the reference appends one mm_idx_dump per index part to a single
    file (main.c:404+ loop), and mm_idx_reader_read loads them back in
    sequence (index.c:609-615)."""
    with open(path, "rb") as f:
        while True:
            idx = _load_mmi_part(f)
            if idx is None:
                return
            yield idx


def _load_mmi_part(f) -> "MinimizerIndex | None":
    """Read one index part from an open .mmi stream; None at EOF.

    Bucket khash entries reconstruct to minimizer hashes as
    (key>>1)<<b | bucket; key bit 0 set means the value IS the single
    packed position, otherwise it is off<<32|cnt into the bucket's p[].
    """
    magic = f.read(4)
    if magic != MMI_MAGIC:
        return None
    w, k, b, n_seq, flag = np.frombuffer(f.read(20), np.uint32)
    names: list[str] = []
    lens = np.empty(n_seq, np.uint32)
    for i in range(n_seq):
        ln = f.read(1)[0]
        names.append(f.read(ln).decode() if ln else str(i))
        lens[i] = np.frombuffer(f.read(4), np.uint32)[0]
    offsets = np.zeros(n_seq, np.uint64)
    total = 0
    for i in range(n_seq):
        offsets[i] = total
        total += int(lens[i])
    hash_chunks = []
    pos_chunks = []
    for i in range(1 << int(b)):
        n_p = int(np.frombuffer(f.read(4), np.uint32)[0])
        p = np.frombuffer(f.read(8 * n_p), np.uint64)
        size = int(np.frombuffer(f.read(4), np.uint32)[0])
        if size == 0:
            continue
        kv = np.frombuffer(f.read(16 * size), np.uint64).reshape(size, 2)
        keys, vals = kv[:, 0], kv[:, 1]
        minier = ((keys >> np.uint64(1)) << np.uint64(int(b))) \
            | np.uint64(i)
        single = (keys & np.uint64(1)) == 1
        if single.any():
            hash_chunks.append(minier[single])
            pos_chunks.append(vals[single])
        multi = ~single
        if multi.any():
            off = (vals[multi] >> np.uint64(32)).astype(np.int64)
            cnt = (vals[multi] & np.uint64(0xFFFFFFFF)).astype(np.int64)
            reps = np.repeat(minier[multi], cnt)
            idx = np.repeat(off, cnt) + (
                np.arange(reps.shape[0], dtype=np.int64)
                - np.repeat(np.cumsum(cnt) - cnt, cnt))
            hash_chunks.append(reps)
            pos_chunks.append(p[idx])
    if hash_chunks:
        occ_hash = np.concatenate(hash_chunks)
        occ_pos = np.concatenate(pos_chunks)
        order = np.lexsort((occ_pos, occ_hash))
        occ_hash = np.ascontiguousarray(occ_hash[order])
        occ_pos = np.ascontiguousarray(occ_pos[order])
    else:
        occ_hash = np.empty(0, np.uint64)
        occ_pos = np.empty(0, np.uint64)
    seq_codes = np.empty(total, np.uint8)
    if not (int(flag) & MM_I_NO_SEQ):
        n_words = (total + 7) // 8
        S = np.frombuffer(f.read(4 * n_words), np.uint32)
        nib = np.empty(n_words * 8, np.uint8)
        for j in range(8):  # unpack 4-bit codes (mm_seq4_get)
            nib[j::8] = ((S >> np.uint32(4 * j)) & np.uint32(0xF)
                         ).astype(np.uint8)
        seq_codes = nib[:total]
    return MinimizerIndex(int(k), int(w), int(flag), names, lens,
                          offsets, seq_codes, occ_hash, occ_pos)


def _save_mmi(index: "MinimizerIndex", path: str) -> None:
    """Write the reference's binary index format (mm_idx_dump,
    index.c:463-502); loadable by minimap2 v2.24."""
    with open(path, "wb") as f:
        _save_mmi_part(index, f)


def save_mmi_parts(parts, path: str) -> int:
    """Append successive index parts to one .mmi, exactly as the
    reference's -d with a multi-part index does (one mm_idx_dump per
    part into idx_rdr->fp_out, main.c:404+ / index.c:619)."""
    n = 0
    with open(path, "wb") as f:
        for index in parts:
            _save_mmi_part(index, f)
            n += 1
    return n


def _save_mmi_part(index: "MinimizerIndex", f) -> None:
    b = 14
    mask = np.uint64((1 << b) - 1)
    f.write(MMI_MAGIC)
    np.array([index.w, index.k, b, index.n_seq, index.flag],
             np.uint32).tofile(f)
    for i in range(index.n_seq):
        name = index.names[i].encode()[:255]
        f.write(bytes([len(name)]))
        f.write(name)
        np.array([index.lens[i]], np.uint32).tofile(f)
    buckets = (index.occ_hash & mask).astype(np.int64)
    # group by (bucket, key): occ table is already hash-sorted
    for i in range(1 << b):
        sel = np.nonzero(buckets == i)[0]
        h = index.occ_hash[sel]
        pos = index.occ_pos[sel]
        uniq, starts, counts = np.unique(h, return_index=True,
                                         return_counts=True)
        singles = counts == 1
        p = pos[np.concatenate([
            np.arange(s, s + c) for s, c, m in
            zip(starts, counts, singles) if not m]) if (~singles).any()
            else np.empty(0, np.int64)]
        np.array([p.shape[0]], np.uint32).tofile(f)
        p.astype(np.uint64).tofile(f)
        np.array([uniq.shape[0]], np.uint32).tofile(f)
        if uniq.shape[0] == 0:
            continue
        kv = np.empty((uniq.shape[0], 2), np.uint64)
        off = 0
        for j, (u, s, c) in enumerate(zip(uniq, starts, counts)):
            key = (u >> np.uint64(b)) << np.uint64(1)
            if c == 1:
                kv[j] = (key | np.uint64(1), pos[s])
            else:
                kv[j] = (key, (np.uint64(off) << np.uint64(32))
                         | np.uint64(c))
                off += int(c)
        kv.tofile(f)
    if not (index.flag & MM_I_NO_SEQ):
        total = int(index.lens.sum())
        n_words = (total + 7) // 8
        nib = np.zeros(n_words * 8, np.uint8)
        nib[:total] = index.seq_codes
        S = np.zeros(n_words, np.uint32)
        for j in range(8):
            S |= nib[j::8].astype(np.uint32) << np.uint32(4 * j)
        S.tofile(f)


def from_fasta_parts2(path: str, opts: IndexOptions, batch_size: int):
    """Yield (index, is_last) multi-part indices of >= batch_size bases
    each (mm_idx_reader_read batching, index.c:583-628).  is_last mirrors
    mm_idx_reader_eof (main.c:413) via a one-record lookahead.

    Prebuilt targets yield their stored parts: a multi-part .mmi replays
    the parts as dumped (batch_size is ignored, like the reference's
    reader for .idx inputs, index.c:609-615); .npz is single-part."""
    if path.endswith(".npz"):
        yield MinimizerIndex.load(path), True
        return
    if _is_mmi(path):
        it = load_mmi_parts(path)
        pending = next(it, None)
        pid = 0
        while pending is not None:
            nxt = next(it, None)
            pending.index_id = pid
            pid += 1
            yield pending, nxt is None
            pending = nxt
        return
    it = read_fastx(path)
    part: list[SeqRecord] = []
    total = 0
    part_id = 0
    pending = next(it, None)
    while pending is not None:
        part.append(pending)
        total += pending.length
        pending = next(it, None)
        if total >= batch_size or pending is None:
            yield MinimizerIndex.build(part, opts, part_id), pending is None
            part, total = [], 0
            part_id += 1


def from_fasta_parts(path: str, opts: IndexOptions, batch_size: int):
    """Yield multi-part indices (see from_fasta_parts2)."""
    for index, _last in from_fasta_parts2(path, opts, batch_size):
        yield index


def read_alt_list(index: "MinimizerIndex", path: str) -> int:
    """Mark ALT contigs by name (mm_idx_alt_read, index.c:636-658)."""
    n_alt = 0
    name2id = {n: i for i, n in enumerate(index.names)}
    opener = gzip.open if path.endswith(".gz") else open  # gzopen index.c:642
    with opener(path, "rt") as f:
        for line in f:
            name = line.split()[0] if line.split() else ""
            rid = name2id.get(name, -1)
            if rid >= 0:
                index.alt_mask[rid] = True
                n_alt += 1
    index.n_alt = n_alt
    return n_alt


def read_junc_bed(index: "MinimizerIndex", path: str,
                  read_junc: bool = True) -> None:
    """Load BED (incl. BED12 intron extraction) junction intervals
    (mm_idx_read_bed / mm_idx_bed_read, index.c:663-751).

    Stores per-rid interval lists as index.junc[rid] = sorted
    (st, en, strand) tuples; consumed by bed_junc()."""
    name2id = {n: i for i, n in enumerate(index.names)}
    intervals: list[list[tuple[int, int, int]]] = \
        [[] for _ in range(index.n_seq)]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 3:
                continue
            rid = name2id.get(t[0], -1)
            if rid < 0:
                continue
            try:
                st, en = int(t[1]), int(t[2])
            except ValueError:
                continue
            if st < 0 or st >= en:
                continue
            strand = 0
            if len(t) > 5:
                strand = 1 if t[5] == "+" else -1 if t[5] == "-" else 0
            if len(t) >= 12 and read_junc:  # BED12: introns between blocks
                try:
                    n_blk = int(t[9])
                    sizes = [int(v) for v in t[10].rstrip(",").split(",")]
                    starts = [int(v) for v in t[11].rstrip(",").split(",")]
                except ValueError:
                    continue
                prev_en = st + starts[0] + sizes[0]
                for b in range(1, n_blk):
                    i_st, i_en = prev_en, st + starts[b]
                    prev_en = st + starts[b] + sizes[b]
                    if i_en > i_st:
                        intervals[rid].append((i_st, i_en, strand))
            else:
                intervals[rid].append((st, en, strand))
    index.junc = [sorted(iv) for iv in intervals]


def bed_junc(index: "MinimizerIndex", rid: int, st: int, en: int
             ) -> np.ndarray:
    """Junction bonus flags over [st, en) (mm_idx_bed_junc, index.c:753-776):
    bit0/1 donor/acceptor on +, bit3/2 on -."""
    s = np.zeros(en - st, np.uint8)
    junc = getattr(index, "junc", None)
    if junc is None or rid < 0 or rid >= index.n_seq:
        return s
    for i_st, i_en, strand in junc[rid]:
        if st <= i_st and en >= i_en and strand != 0:
            if strand > 0:
                s[i_st - st] |= 1
                s[i_en - 1 - st] |= 2
            else:
                s[i_st - st] |= 8
                s[i_en - 1 - st] |= 4
    return s
