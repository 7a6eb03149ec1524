"""The read simulator the benchmark's generators build on.

Frozen copy of random_reference and simulate_read from
mm2_gb_tpu_torch/utils/simulate.py at
commit 622041211370967fed91c3d03b9d93712cf20ff8, with `revcomp` defined
here instead of imported from the program.  They write no file.
"""

from __future__ import annotations

import numpy as np

_COMP = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def revcomp(seq: str) -> str:
    """Reverse complement of a DNA string."""
    return seq.encode().translate(_COMP)[::-1].decode()


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
        seq = revcomp(seq)
    return seq
