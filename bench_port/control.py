"""The output check's control: a mapper that breaks the configuration's
guarantee must come out as not correct.

    python3 bench_port/control.py --workload CELL --seeds N [N ...]

For each seed it makes the cell's genome and read pool, draws the reads
a run's check samples where the window finishes the whole pool, and puts in the program's place the plain
reference computed in the precision below the one minimap2 and the
port compute in (reference/check.use_control): the chain scores, the
DP's or RMQ's, in int16 instead of int32, the chain gap cost and the
divergence estimates in bfloat16 instead of float32; the check's own
comparison holds it to the reference as computed.  It
prints one JSON line a seed with each number.  It needs no card: the
benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def control(cell, seed: int, n_check: int | None = None) -> dict:
    """{number: value} of the control on one seed, and "correct"."""
    from bench_port import harness
    from bench_port.reference import check as ref
    g = dict(cell.config["genome"], length=cell.config["genome_length"],
             chromosomes=cell.config["chromosomes"])
    chroms, _ = harness.generator(g["generator"])(g, seed)
    pool = harness.generator(cell.traffic["generator"])(cell.traffic, chroms,
                                                        seed)
    n = n_check or int(cell.traffic["check_reads"])
    lengths = [len(s) for _, s in pool]
    longest, drawn = harness.candidates(lengths, n, seed)
    reads = [pool[i] for i in harness.sample(longest, drawn,
                                             set(range(len(pool))),
                                             lengths, n)]
    argv = list(cell.config["argv"])
    index, _ = ref.index_and_options(chroms, argv)
    want = ref.map_reads(index, argv, reads)
    got = ref.map_reads(index, argv, reads, control="lower")
    nums = harness.compare([n for n, _ in reads], got, want)
    return dict(nums, correct=all(v <= harness.LIMITS[k]
                                  for k, v in nums.items()),
                reads=len(reads))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from bench_port import harness
    cell = harness.load_cell(a.workload, root)
    for seed in a.seeds:
        t = time.perf_counter()
        res = control(cell, seed)
        res.update(workload=a.workload, seed=seed,
                   seconds=time.perf_counter() - t)
        sys.stdout.write(json.dumps(res) + "\n")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
