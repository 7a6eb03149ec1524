"""The read pool of a traffic mix, made from the run's seed.

`make(params, chroms, seed)` returns [(name, sequence)]: n_reads reads
whose lengths are the quantiles (i + 0.5) / n_reads of `length`, each
from a uniform position of a chromosome picked in proportion to its
length, on either strand, with simulate.simulate_read's substitutions,
insertions and deletions at the mix's `errors`.  The order of the
lengths, the chromosomes, the positions and the strands come from a
generator of a fixed seed (LAYOUT), the same for every seed, as the
genome's layout is (gen/genome.py), so that every seed gives the mapper
the same work; the run's seed draws the errors, and the genome's bases
under the reads.  A read's name is chrom_index_start_length and its
strand: the read's origin, which the output check reads.

`length` is {"kind": "uniform", "min", "max"}.
"""

from __future__ import annotations

import numpy as np

from bench_port.gen import simulate

LAYOUT = 0x1A70


def lengths(spec: dict, n: int) -> np.ndarray:
    """The n read lengths of `spec`, shortest first."""
    u = (np.arange(n) + 0.5) / n
    if spec["kind"] != "uniform":
        raise ValueError(f"unknown length kind {spec['kind']!r}")
    out = spec["min"] + u * (spec["max"] - spec["min"])
    return np.clip(np.round(out), spec["min"], spec["max"]).astype(np.int64)


def make(params: dict, chroms: list[tuple[str, str]], seed: int
         ) -> list[tuple[str, str]]:
    n = int(params["n_reads"])
    err = params["errors"]
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64,
                                                        0x5EAD]))
    lay = np.random.default_rng(np.random.SeedSequence([LAYOUT, 0x5EAD]))
    lens = lay.permutation(lengths(params["length"], n))
    clen = np.array([len(s) for _, s in chroms], np.int64)
    which = lay.choice(len(chroms), n, p=clen / clen.sum())
    read_seeds = rng.integers(0, 2**63, n)
    out = []
    for i in range(n):
        name, seq = chroms[int(which[i])]
        ln = int(min(lens[i], len(seq) - 1))
        st = int(lay.integers(0, len(seq) - ln))
        rev = bool(lay.integers(0, 2))
        read = simulate.simulate_read(
            seq, st, ln, sub_rate=err["sub"], ins_rate=err["ins"],
            del_rate=err["del"], rev=rev, seed=int(read_seeds[i]))
        out.append((f"{name}_{i}_{st}_{ln}{'-' if rev else '+'}", read))
    return out
