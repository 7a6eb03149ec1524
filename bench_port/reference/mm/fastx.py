# Frozen copy of mm2_gb_tpu_torch/utils/fastx.py
# at commit 622041211370967fed91c3d03b9d93712cf20ff8, for the
# benchmark's plain reference: the text as it stands there, but its
# imports point into this folder, where native.py says that the C++
# host kit is absent, so every NumPy branch runs.  Do not follow the
# program's later changes here.
"""FASTA/FASTQ sequence input (the bseq.c/kseq.h layer, rebuilt).

Provides streaming batched reads grouped by base count, matching the
reference's mini-batch reader semantics (bseq.c:80-129 mm_bseq_read3:
accumulate sequences until >= chunk_size bases, always finishing the
current record).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, Iterable


@dataclass
class SeqRecord:
    """One input sequence (mm_bseq1_t analog, bseq.h:10-18)."""
    rid: int
    name: str
    seq: str
    qual: str | None = None
    comment: str | None = None

    @property
    def length(self) -> int:
        return len(self.seq)


def _open_text(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rt")
    import io
    return io.TextIOWrapper(f)


def read_fastx(path: str, start_rid: int = 0) -> Iterator[SeqRecord]:
    """Stream records from a (possibly gzipped) FASTA or FASTQ file.

    Name is the first whitespace-delimited token; the rest of the header
    line becomes the comment (kseq.h tokenization).
    """
    rid = start_rid
    with _open_text(path) as f:
        header = None
        seq_parts: list[str] = []
        first = f.read(1)
        if not first:
            return
        if first == ">":
            line = f.readline()
            header = line.rstrip("\n")
            for raw in f:
                if raw.startswith(">"):
                    yield _make_record(rid, header, "".join(seq_parts))
                    rid += 1
                    header = raw[1:].rstrip("\n")
                    seq_parts = []
                else:
                    seq_parts.append(raw.strip())
            if header is not None:
                yield _make_record(rid, header, "".join(seq_parts))
        elif first == "@":
            # FASTQ: strictly 4-line records (sufficient for mapper input)
            while True:
                hline = f.readline() if header is None else header
                header = None
                if not hline:
                    break
                hdr = hline.rstrip("\n")
                seq = f.readline().rstrip("\n")
                f.readline()  # '+'
                qual = f.readline().rstrip("\n")
                yield _make_record(rid, hdr, seq, qual)
                rid += 1
                nxt = f.read(1)
                if not nxt:
                    break
                assert nxt == "@", "malformed FASTQ"
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _make_record(rid: int, header: str, seq: str, qual: str | None = None) -> SeqRecord:
    parts = header.split(None, 1)
    name = parts[0] if parts else ""
    comment = parts[1] if len(parts) > 1 else None
    return SeqRecord(rid=rid, name=name, seq=seq, qual=qual, comment=comment)


def read_batches(paths: Iterable[str], chunk_bases: int) -> Iterator[list[SeqRecord]]:
    """Yield lists of records totalling >= chunk_bases (last batch may be short)."""
    batch: list[SeqRecord] = []
    total = 0
    rid = 0
    for path in paths:
        for rec in read_fastx(path, start_rid=rid):
            rid = rec.rid + 1
            batch.append(rec)
            total += rec.length
            if total >= chunk_bases:
                yield batch
                batch, total = [], 0
    if batch:
        yield batch


_COMP = str.maketrans("ACGTUacgtuNnRYSWKMBDHVryswkmbdhv",
                      "TGCAAtgcaaNnYRSWMKVHDByrswmkvhdb")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]
