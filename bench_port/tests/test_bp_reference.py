"""The reference's own pieces: its NumPy index sketch against the frozen
sketch_py, its option parsing, and its control."""

import numpy as np
import pytest

from bench_port.tests import bp_tiny
from bench_port import control
from bench_port.gen import genome
from bench_port.reference import check as ref
from bench_port.reference import refindex
from bench_port.reference.mm import opts as O
from bench_port.reference.mm.sketch import _NT4, sketch_py


def _seqs():
    rng = np.random.default_rng(1)
    rand = rng.choice(np.frombuffer(b"ACGT", np.uint8), 60000).tobytes() \
        .decode()
    unit = rand[:37]
    g = {"length": 200_000, "chromosomes": 1,
         "sine": {"families": 2, "consensus_length": 300, "share": 0.10,
                  "divergence": [0.0, 0.02]}}
    chroms, _ = genome.make(g, 5)
    return [rand, rand[:5000] + unit * 300 + "A" * 200 + "AC" * 300
            + rand[5000:20000], chroms[0][1]]


@pytest.mark.parametrize("k,w", [(15, 10), (19, 19), (15, 5)])
def test_sketch_set_equals_sketch_py(k, w):
    for s in _seqs():
        a = sketch_py(s, w, k, 3, False)
        want = set(zip((a[:, 0] >> np.uint64(8)).tolist(), a[:, 1].tolist()))
        h, p = refindex.sketch_set(_NT4[np.frombuffer(s.encode(), np.uint8)],
                                   w, k, 3)
        assert set(zip(h.tolist(), p.tolist())) == want
        assert h.shape[0] == a.shape[0]


def test_options_of_the_configurations():
    io, mo = ref.options(bp_tiny.cell("hifi.sam").config["argv"])
    assert mo.max_chain_skip == 2**31 - 1
    assert mo.flag & O.MM_F_OUT_SAM and mo.flag & O.MM_F_CIGAR
    io, mo = ref.options(["-x", "map-ont", "--gpu-chain",
                          "--max-chain-skip=2147483647", "-t", "8"])
    assert mo.max_chain_skip == 2**31 - 1
    assert not mo.flag & O.MM_F_OUT_SAM
    with pytest.raises(ValueError):
        ref.options(["-x", "map-ont", "--secondary=no"])


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.00390625, 1.005859375, 3.14159], np.float32)
    assert ref.bf16(x).tolist() == [1.0, 1.0, 1.0078125, 3.140625]


def test_control_comes_out_not_correct():
    """The reference computed a precision lower, in the program's place,
    fails the check's comparison: on HiFi reads by the divergence in
    bfloat16 (every record's de tag)."""
    res = control.control(bp_tiny.cell("hifi.sam"), 1, n_check=3)
    assert res["correct"] is False and res["records_differ"] > 0


def test_int16_chain_scores_wrap_on_long_chains():
    """The control's int16 chain scores equal the int32 ones while they
    fit, and differ once a chain's score passes 32767."""
    n = 3000
    ax = (np.arange(n, dtype=np.uint64) * np.uint64(15))
    ay = (np.uint64(15) << np.uint64(32)) | (np.arange(n, dtype=np.uint64)
                                             * np.uint64(15))
    args = (5000, 5000, 500, 2**31 - 1, 5000, np.float32(0.12),
            np.float32(0.0), False, 1)
    f32, p32 = ref._DP32(ax, ay, *args)
    f16, p16 = ref.chain_dp_scores_i16(ax, ay, *args)
    fits = f32 <= 32767
    assert f32.max() > 32767 and fits.sum() > 100
    assert np.array_equal(f16[fits], f32[fits])
    assert not np.array_equal(f16, f32)
    assert np.array_equal(p16[fits], p32[fits])
