"""Deterministic merge of multi-host PAF/SAM shards (SURVEY.md §5.8).

Each rank of a `--tpu-nproc N -o OUT` run writes OUT.shard<r> plus
OUT.shard<r>.idx with one `(file_ordinal, global_read_idx, n_lines)`
record per mapped read, a sort-first `(-1, -1)` record for the SAM
header on rank 0, and a trailing `#done <n_records>` sentinel.  This
tool k-way-merges the shards by (file_ordinal, global_read_idx) — the
same order a single-host run emits, so the merged bytes equal the
single-host output.

Integrity (validated BEFORE any output is written): a missing shard, a
missing/mismatched `#done` sentinel, a shard body whose line count
disagrees with its idx, a read owned by the wrong rank
(global_read_idx % nproc != rank), or a gap in the per-file read-index
sequence all abort with a non-zero exit instead of silently truncating
the merge.  Bodies stream through the merge; only the (small) idx
sidecars are held in memory.

Usage:  python -m mm2_gb_tpu_torch.tools.mergeshards <OUT> <N> [> merged.out]
"""

from __future__ import annotations

import heapq
import sys


class ShardError(RuntimeError):
    pass


def _load_idx(prefix: str, rank: int, nproc: int):
    """Parse + validate one rank's idx sidecar and check the shard body's
    line count (streamed).  Returns [(fi, gidx, n_lines)]."""
    try:
        idx_lines = open(f"{prefix}.shard{rank}.idx").read().splitlines()
    except OSError as e:
        raise ShardError(f"rank {rank}: missing idx sidecar ({e})") from e
    if not idx_lines or not idx_lines[-1].startswith("#done\t"):
        raise ShardError(
            f"rank {rank}: no #done sentinel — the rank crashed or was "
            f"truncated; refusing to merge")
    n_done = int(idx_lines[-1].split("\t")[1])
    recs = []
    totals: dict[int, int] = {}
    for raw in idx_lines[:-1]:
        if raw.startswith("#file\t"):
            _, fi, n = raw.split("\t")
            totals[int(fi)] = int(n)
            continue
        fi, gidx, n_lines = (int(v) for v in raw.split("\t"))
        if fi >= 0 and gidx % nproc != rank:
            raise ShardError(
                f"rank {rank}: read index {gidx} belongs to rank "
                f"{gidx % nproc}")
        recs.append((fi, gidx, n_lines))
    if len(recs) != n_done:
        raise ShardError(
            f"rank {rank}: idx has {len(recs)} records but sentinel "
            f"says {n_done}")
    expect = sum(r[2] for r in recs)
    actual = 0
    try:
        with open(f"{prefix}.shard{rank}", "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                actual += chunk.count(b"\n")
    except OSError as e:
        raise ShardError(f"rank {rank}: missing shard body ({e})") from e
    if actual != expect:
        raise ShardError(
            f"rank {rank}: shard body has {actual} lines but the idx "
            f"claims {expect} — truncated or trailing data")
    return recs, totals


def merge(prefix: str, nproc: int, out) -> int:
    loaded = [_load_idx(prefix, r, nproc) for r in range(nproc)]
    per_rank = [recs for recs, _t in loaded]

    # per-file completeness across ranks.  Every rank scans the whole
    # file and records its total in a #file record, so the ranks must
    # agree on each file's read count and the union of read indices must
    # be exactly range(total) — detecting interior holes AND trailing
    # losses (e.g. one rank ran against a truncated copy of the file)
    totals: dict[int, int] = {}
    for r, (_recs, t) in enumerate(loaded):
        for fi, n in t.items():
            if fi in totals and totals[fi] != n:
                raise ShardError(
                    f"file {fi}: ranks disagree on its read count "
                    f"({totals[fi]} vs rank {r}'s {n})")
            totals.setdefault(fi, n)
    seen: dict[int, set] = {}
    for recs in per_rank:
        for fi, gidx, _ in recs:
            if fi >= 0:
                seen.setdefault(fi, set()).add(gidx)
    for fi, idxs in seen.items():
        want = totals.get(fi, max(idxs) + 1)
        if len(idxs) != want or (idxs and max(idxs) + 1 > want):
            missing = sorted(set(range(want)) - idxs)[:5]
            raise ShardError(
                f"file {fi}: {abs(want - len(idxs))} reads missing from "
                f"the shards (first: {missing})")
    # a file ALL ranks counted but none shipped records for must also
    # abort, not silently vanish from the merged output
    for fi, want in totals.items():
        if want > 0 and fi not in seen:
            raise ShardError(
                f"file {fi}: ranks report {want} reads but no shard "
                f"carries any record for it")

    bodies = [open(f"{prefix}.shard{r}") for r in range(nproc)]
    try:
        iters = [iter(recs) for recs in per_rank]
        heap = []

        def push(r):
            rec = next(iters[r], None)
            if rec is not None:
                fi, gidx, n_lines = rec
                chunk = "".join(bodies[r].readline()
                                for _ in range(n_lines))
                heapq.heappush(heap, (fi, gidx, r, chunk))

        for r in range(nproc):
            push(r)
        while heap:
            _fi, _gidx, r, chunk = heapq.heappop(heap)
            out.write(chunk)
            push(r)
    finally:
        for f in bodies:
            f.close()
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        sys.stderr.write(__doc__ + "\n")
        return 1
    try:
        return merge(argv[0], int(argv[1]), sys.stdout)
    except ShardError as e:
        sys.stderr.write(f"[ERROR] {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
