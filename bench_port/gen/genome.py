"""The reference genome of a configuration, made from the run's seed.

`make(params, seed)` returns the chromosomes as [(name, str)] and
the share of the genome each repeat class covers.  Each chromosome
starts as random bases (simulate.random_reference, as the smoke's
`_genome` made its chromosomes), and then copies of repeat families are
written over it, in this order:

- "line": LINE-like families whose copies are 3' pieces of a consensus
  (min_length to the consensus length), each copy diverged by a rate
  drawn from `divergence` (substitutions, and a tenth of that in
  insertions and in deletions);
- "sine": SINE-like families of a short consensus, diverged alike.

Each class is planted until its share of the genome (the bases its
copies last wrote) reaches `share`; a later class overwrites part of an
earlier one, so the earlier ones aim above their share by what the
later ones take.  The k-th copy of a class has the same family, length
and divergence for every seed, from a low-discrepancy sequence over
their ranges, and the same chromosome, position and strand, from a
generator of a fixed seed (LAYOUT): every seed plants the same copies
in the same places, so that every seed gives the mapper the same work.
The run's seed draws every base: the chromosomes, the consensus
sequences and each copy's mutations.
"""

from __future__ import annotations

import numpy as np

from bench_port.gen import simulate

_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[_BASES] = np.frombuffer(b"TGCA", np.uint8)
ORDER = ("line", "sine")
LAYOUT = 0x1A70


def _diverge(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    """seq with substitutions at `rate` and insertions and deletions at
    a tenth of it each."""
    seq = seq.copy()
    sub = rng.random(seq.shape[0]) < rate
    seq[sub] = _BASES[rng.integers(0, 4, int(sub.sum()))]
    seq = seq[rng.random(seq.shape[0]) >= rate / 10]
    ins = np.nonzero(rng.random(seq.shape[0]) < rate / 10)[0]
    if ins.shape[0]:
        seq = np.insert(seq, ins, _BASES[rng.integers(0, 4, ins.shape[0])])
    return seq


# the fractional parts of k * these are well spread for every prefix of
# k = 1, 2, ... (Kronecker sequences); one for each property of a copy
_KRONECKER = (0.6180339887498949, 0.4142135623730951)


def _spread(k: int, which: int, lo: float, hi: float) -> float:
    return lo + (k * _KRONECKER[which] % 1.0) * (hi - lo)


def _copy(rng, k: int, p: dict, families: list) -> np.ndarray:
    """The k-th copy of a repeat class of parameters `p`, forward."""
    div = _spread(k, 0, *p["divergence"])
    cons = families[k % len(families)]
    n = cons.shape[0]
    if "min_length" in p:   # a 3' piece of the consensus
        n = round(_spread(k, 1, p["min_length"], cons.shape[0]))
    return _diverge(rng, cons[cons.shape[0] - n:], div)


def _aim(classes: dict, cls: str) -> float:
    """The share class `cls` is planted to: its own, raised by what the
    classes planted after it overwrite."""
    later = [classes[c]["share"] for c in ORDER[ORDER.index(cls) + 1:]
             if c in classes]
    return classes[cls]["share"] / float(np.prod([1.0 - s for s in later]))


def make(params: dict, seed: int) -> tuple[list[tuple[str, str]], dict]:
    """([(name, sequence)], {class: share of the genome}) of the genome
    `params` describes (length, chromosomes, and the repeat classes)."""
    n_chrom = int(params["chromosomes"])
    clen = int(params["length"]) // n_chrom
    classes = {c: params[c] for c in ORDER if c in params}
    ss = np.random.SeedSequence([seed % 2**64, 0x9E7A])
    chrom_seeds, plant_seed = ss.spawn(2)
    genome = np.concatenate([
        np.frombuffer(simulate.random_reference(
            clen, seed=int(s.generate_state(1)[0])).encode(), np.uint8)
        for s in chrom_seeds.spawn(n_chrom)])
    owner = np.zeros(genome.shape[0], np.uint8)   # 0: none, else class + 1
    rng = np.random.default_rng(plant_seed)
    # where each copy goes and its strand, the same for every seed; the
    # position as a share of the room, so that a copy's length, which
    # the seed's indels move, never shifts the draws that follow
    lay = np.random.default_rng(np.random.SeedSequence([LAYOUT, 0x9E7A]))
    shares = {}
    for ci, cls in enumerate(ORDER):
        if cls not in classes:
            continue
        p = classes[cls]
        families = [_BASES[rng.integers(0, 4, int(p["consensus_length"]))]
                    for _ in range(int(p.get("families", 0)))]
        target = _aim(classes, cls) * genome.shape[0]
        covered, k = 0, 0
        while covered < target:
            k += 1
            piece = _copy(rng, k, p, families)
            if lay.random() < 0.5:
                piece = _COMP[piece[::-1]]
            # a copy lies inside one chromosome
            c = int(lay.integers(0, n_chrom))
            pos = c * clen + int(lay.random() * (clen - piece.shape[0]))
            span = slice(pos, pos + piece.shape[0])
            covered += int(np.count_nonzero(owner[span] != ci + 1))
            genome[span] = piece
            owner[span] = ci + 1
    for ci, cls in enumerate(ORDER):
        if cls in classes:
            shares[cls] = float(np.count_nonzero(owner == ci + 1)
                                / genome.shape[0])
    chroms = [(f"chr{c + 1}", genome[c * clen:(c + 1) * clen].tobytes()
               .decode()) for c in range(n_chrom)]
    return chroms, shares
