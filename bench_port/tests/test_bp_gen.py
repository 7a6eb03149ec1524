"""The generators: deterministic by seed, the same read lengths for
every seed, repeat shares within their stated ranges."""

from bench_port.tests import bp_tiny  # noqa: F401  (puts the root on the path)
from bench_port.gen import genome, reads

G = {"length": 2_000_000, "chromosomes": 2,
     "line": {"families": 4, "consensus_length": 6000, "min_length": 500,
              "share": 0.17, "divergence": [0.02, 0.20]},
     "sine": {"families": 4, "consensus_length": 300, "share": 0.10,
              "divergence": [0.02, 0.20]}}
MIX = {"n_reads": 50, "errors": {"sub": 0.001, "ins": 0.0005,
                                  "del": 0.0005},
       "length": {"kind": "uniform", "min": 15000, "max": 25000}}

def test_genome_is_deterministic_by_seed():
    a, sa = genome.make(G, 2**31 + 7)
    b, sb = genome.make(G, 2**31 + 7)
    c, _ = genome.make(G, 2**31 + 8)
    assert a == b and sa == sb
    assert a != c
    assert [len(s) for _, s in a] == [1_000_000, 1_000_000]
    assert set("".join(s for _, s in a)) <= set("ACGT")

def test_repeat_shares_within_their_ranges():
    _, shares = genome.make(G, 3)
    assert set(shares) == {"line", "sine"}
    assert 0.15 <= shares["line"] <= 0.19
    assert 0.09 <= shares["sine"] <= 0.11

def test_repeats_repeat():
    """A SINE-like family's copies share k-mers across the genome: the
    most common 15-mer occurs far more often than in random sequence
    (where it occurs two or three times in 500 kb)."""
    chroms, _ = genome.make(G, 5)
    seq = chroms[0][1][:500_000]
    counts = {}
    for i in range(len(seq) - 15):
        k = seq[i:i + 15]
        counts[k] = counts.get(k, 0) + 1
    assert max(counts.values()) > 8

def test_every_seed_has_the_same_layout():
    """Two seeds plant the same repeat copies in the same places and
    draw reads of the same lengths from the same places, over other
    bases."""
    a, sa = genome.make(G, 2**31 + 1)
    b, sb = genome.make(G, 2**31 + 2)
    assert abs(sa["line"] - sb["line"]) < 0.002
    assert abs(sa["sine"] - sb["sine"]) < 0.002
    ra, rb = reads.make(MIX, a, 7), reads.make(MIX, b, 8)
    assert [n for n, _ in ra] == [n for n, _ in rb]
    assert all(x != y for (_, x), (_, y) in zip(ra, rb))


def test_reads_deterministic_and_same_lengths_for_every_seed():
    chroms, _ = genome.make(G, 1)
    a = reads.make(MIX, chroms, 11)
    b = reads.make(MIX, chroms, 11)
    c = reads.make(MIX, chroms, 2**31 + 99)
    assert a == b
    assert a != c
    la = sorted(int(n.split("_")[3][:-1]) for n, _ in a)
    lc = sorted(int(n.split("_")[3][:-1]) for n, _ in c)
    assert la == lc == sorted(reads.lengths(MIX["length"], 50).tolist())
    assert all(15000 <= x <= 25000 for x in la)

def test_uniform_lengths_are_the_quantiles():
    got = reads.lengths({"kind": "uniform", "min": 100, "max": 200}, 4)
    assert got.tolist() == [112, 138, 162, 188]


def test_an_unknown_length_kind_is_refused():
    try:
        reads.lengths({"kind": "lognormal", "min": 1, "max": 2}, 4)
    except ValueError:
        return
    raise AssertionError("an unknown length kind was taken")


def test_a_read_is_the_genome_at_its_origin():
    """The name gives the read's origin: an error-free read is the
    genome there, reverse-complemented on '-'."""
    from bench_port.gen import simulate
    from bench_port.reference import truth
    chroms, _ = genome.make(G, 4)
    mix = dict(MIX, n_reads=6, errors={"sub": 0, "ins": 0, "del": 0})
    for name, seq in reads.make(mix, chroms, 2**31 + 3):
        chrom, start, end, rev = truth.origin(name)
        want = dict(chroms)[chrom][start:end]
        assert seq == (simulate.revcomp(want) if rev else want)
