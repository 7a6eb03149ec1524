"""Synthetic read simulation for benchmarks and tests.

Generates a random reference and ONT-like reads with substitutions and
indels — the anchor statistics (density, gap structure) approximate the
10–100 kb nanopore workload the reference benchmarks against
(BASELINE.md configs).
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_reference(length: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    return rng.choice(_BASES, length).tobytes().decode()


def simulate_read(ref: str, start: int, length: int, *, sub_rate=0.04,
                  ins_rate=0.005, del_rate=0.005, rev=False,
                  seed: int = 0) -> str:
    """One noisy read from ref[start:start+length]."""
    rng = np.random.default_rng(seed)
    frag = np.frombuffer(ref[start:start + length].encode(), np.uint8).copy()
    # substitutions
    sub = rng.random(frag.shape[0]) < sub_rate
    frag[sub] = _BASES[rng.integers(0, 4, int(sub.sum()))]
    # deletions
    keep = rng.random(frag.shape[0]) >= del_rate
    frag = frag[keep]
    # insertions
    ins = rng.random(frag.shape[0]) < ins_rate
    n_ins = int(ins.sum())
    if n_ins:
        pos = np.nonzero(ins)[0]
        frag = np.insert(frag, pos, _BASES[rng.integers(0, 4, n_ins)])
    seq = frag.tobytes().decode()
    if rev:
        from mm2_gb_tpu_torch.utils.fastx import revcomp
        seq = revcomp(seq)
    return seq


def simulate_readset(ref: str, n_reads: int, min_len: int, max_len: int,
                     seed: int = 0, **noise) -> list[tuple[str, str]]:
    """Returns [(name, seq)] with lengths uniform in [min_len, max_len]."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_reads):
        ln = int(rng.integers(min_len, max_len + 1))
        ln = min(ln, len(ref) - 1)
        st = int(rng.integers(0, len(ref) - ln))
        rev = bool(rng.integers(0, 2))
        seq = simulate_read(ref, st, ln, rev=rev, seed=seed * 100003 + i,
                            **noise)
        out.append((f"read{i}_{st}_{ln}{'-' if rev else '+'}", seq))
    return out


def random_repetitive_reference(length: int, seed: int = 11,
                                n_arrays: int = 60) -> str:
    """Random reference with planted tandem-repeat arrays.

    Reads crossing an array produce quadratic anchor blowups (every
    query copy hits every reference copy), which is what populates
    chain-segment successor ranges ABOVE the small window class — the
    workload the reference's over50k GPU config exists for
    (gpu/mi210_over50k_config.json)."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(_BASES, length).copy()
    for _ in range(n_arrays):
        unit_len = int(rng.integers(300, 800))
        copies = int(rng.integers(10, 16))   # below typical mid_occ
        unit = _BASES[rng.integers(0, 4, unit_len)]
        arr = np.tile(unit, copies)
        mut = rng.random(arr.shape[0]) < 0.005   # light per-copy divergence
        arr[mut] = _BASES[rng.integers(0, 4, int(mut.sum()))]
        pos = int(rng.integers(0, length - arr.shape[0] - 1))
        ref[pos:pos + arr.shape[0]] = arr
    return ref.tobytes().decode()


def materialize_ultralong(n_reads: int = 40, base_dir: str = "/tmp"
                          ) -> tuple[str, str]:
    """Ultra-long repeat-rich flowcell: 8 Mbp reference with tandem
    arrays + 100-300 kb reads (the reference's over50k case).  Exercises
    the window-class ladder above 768 (ROOFLINE §3's parked gap)."""
    import os
    d = os.path.join(base_dir, f"mm2tpu_bench_ul{n_reads}")
    os.makedirs(d, exist_ok=True)
    ref_fa = os.path.join(d, "ref.fa")
    reads_fa = os.path.join(d, "reads.fa")
    if not (os.path.exists(ref_fa) and os.path.exists(reads_fa)):
        ref = random_repetitive_reference(8_000_000, seed=11)
        reads = simulate_readset(ref, n_reads, 100_000, 300_000, seed=12)
        tmp = ref_fa + ".tmp"
        with open(tmp, "w") as f:
            f.write(">chr1\n")
            for i in range(0, len(ref), 80):
                f.write(ref[i:i + 80] + "\n")
        os.replace(tmp, ref_fa)
        tmp = reads_fa + ".tmp"
        with open(tmp, "w") as f:
            for name, seq in reads:
                f.write(f">{name}\n{seq}\n")
        os.replace(tmp, reads_fa)
    return ref_fa, reads_fa


def materialize_flowcell(n_reads: int, base_dir: str = "/tmp"
                         ) -> tuple[str, str]:
    """Write (and cache on disk) the standard bench flowcell: a 4 Mbp
    random reference and `n_reads` 10-100 kb ONT-like reads.  Both
    bench.py and tools/chip_smoke.py draw from here so their byte gates
    compare identical inputs; the directory is keyed on n_reads so
    different sizes never clobber each other."""
    import os
    d = os.path.join(base_dir, f"mm2tpu_bench_fc{n_reads}")
    os.makedirs(d, exist_ok=True)
    ref_fa = os.path.join(d, "ref.fa")
    reads_fa = os.path.join(d, "reads.fa")
    if not (os.path.exists(ref_fa) and os.path.exists(reads_fa)):
        ref = random_reference(4_000_000, seed=1)
        reads = simulate_readset(ref, n_reads, 10_000, 100_000, seed=3)
        tmp = ref_fa + ".tmp"
        with open(tmp, "w") as f:
            f.write(">chr1\n")
            for i in range(0, len(ref), 80):
                f.write(ref[i:i + 80] + "\n")
        os.replace(tmp, ref_fa)
        tmp = reads_fa + ".tmp"
        with open(tmp, "w") as f:
            for name, seq in reads:
                f.write(f">{name}\n{seq}\n")
        os.replace(tmp, reads_fa)
    return ref_fa, reads_fa
