"""The JAX package's Pallas splice kernel in its track_h branch
(ksw2_tpu.exts2_fwd_tpu(track_h=True), interpret mode on the CPU)
against the port's splice extensions (the exts2_ext twin through
exts2_ext_batch) and the oracle, ksw2_splice.exts2.

No path of the JAX package calls that branch, so the operands are built
here as exts2_batch_device builds them (ksw2_tpu.py:914-926: the unbanded
window w = qlen + tlen, the Z-drop in meta[4], the site scores from
_splice_sites) and the Extz fields are read from the accumulator lanes
2-10.  The oracle decides: the port must equal it on every extension,
and so must the JAX branch except on the extensions named in
JAX_FAULTS (none so far).  One call with KSW_EZ_RIGHT off (the kernel's
`right` is static; each value costs a cold interpret-mode compile of
about two minutes).  Tolerance 0: every field is an integer.
"""

import numpy as np
import pytest
import torch

from chip_smoke import _pack_splice_ext, splice_ext_pairs
from mm2_gb_tpu.ops import ksw2 as jksw2
from mm2_gb_tpu.ops import ksw2_splice as JS
from mm2_gb_tpu_torch.ops import ksw2_gpu as K
from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
from mm2_gb_tpu_torch.utils import opts as O

FIELDS = ("score", "max", "max_t", "max_q", "mqe", "mqe_t", "mte", "mte_q",
          "zdropped")
# extensions (by index) where the JAX branch is known to differ from the
# oracle; see ROADMAP.md queue 3
JAX_FAULTS = ()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _extensions():
    """Eight seeded splice extensions of at most 480 bases a side (the
    512 size class), KSW_EZ_RIGHT off: every kind of splice_ext_pairs
    (spliced, N bases, unrelated, an unrelated tail, indel-rich, one
    exon), forward and reverse sites, REV_CIGAR, FLANK, BED junction
    bytes, Z-drops from 40 to none."""
    rng = np.random.default_rng(2024)
    out = []
    for q, t, flag, junc, zd in splice_ext_pairs(rng, 96, 150, 60, 20):
        if max(len(q), len(t)) <= 480 and not flag & jksw2.KSW_EZ_RIGHT:
            out.append((q, t, flag, junc, zd))
    return out[:8]


def _jax_fields(exts, prm):
    """exts2_fwd_tpu(track_h=True, interpret=True) on the extensions:
    [n, 9] int (FIELDS, from the accumulator's lanes 2-10)."""
    import jax
    import jax.numpy as jnp
    from mm2_gb_tpu.ops import ksw2_tpu as T
    cls = 512
    calls = [T.FillCall(q, t, len(q) + len(t), False, zd)
             for q, t, _f, _j, zd in exts]
    wbnd = T.band_width(max(min(len(q), len(t)) for q, t, *_ in exts) + 64,
                        cls)
    plan = T.plan_fill_light(calls, cls, wbnd)
    assert not plan.dropped.any()
    P = T.PAIRS_PER_GROUP
    dpad = np.zeros((plan.n_groups, P, cls + 16), np.int8)
    apad = np.zeros((plan.n_groups, P, cls + 16), np.int8)
    for k, (_q, t, flag, junc, _zd) in enumerate(exts):
        nbytes = (len(t) + 15) // 16 * 16
        don, acc = JS._splice_sites(t, len(t), nbytes, prm.noncan,
                                    prm.junc_bonus, flag, junc)
        g, pp = divmod(k, P)
        dpad[g, pp, :nbytes], apad[g, pp, :nbytes] = don, acc
    meta = jnp.asarray(plan.meta)
    qb, tb, qk = T.prep_fill_operands(meta, jnp.asarray(plan.qpad),
                                      jnp.asarray(plan.tpad), wb=wbnd,
                                      r_pad=plan.r_pad)
    dband, aband = T.prep_splice_bands(meta, jnp.asarray(dpad),
                                       jnp.asarray(apad), wb=wbnd,
                                       r_pad=plan.r_pad)
    _p, acc = T.exts2_fwd_tpu(
        meta, qb, tb, qk, dband, aband, wb=wbnd, r_pad=plan.r_pad, q=prm.q,
        e=prm.e, q2=prm.q2, mat0=prm.mat0, mat1=prm.mat1, sc_n=prm.sc_n,
        right=False, long_thres=prm.long_thres, long_diff=prm.long_diff,
        track_h=True, interpret=True)
    acc = np.asarray(jax.device_get(acc))
    return np.array([acc[k // P, k % P, 2:11] for k in range(len(exts))],
                    np.int64)


def test_port_and_jax_track_h_against_the_oracle():
    prm = KS.splice_params(O.set_preset("splice")[1])
    exts = _extensions()
    assert len(exts) == 8
    meta, qb, tb, jb, fl, zd = _pack_splice_ext(exts)
    port, cig_off, cig = KS.exts2_ext_batch(meta, qb, tb, jb, fl, zd, prm,
                                            "cpu")
    jax_f = _jax_fields(exts, prm)
    oracle = []
    for k, (q, t, flag, junc, z) in enumerate(exts):
        ez = JS.exts2(q, t, prm.mat, prm.q, prm.e, prm.q2, prm.noncan, z,
                      prm.junc_bonus, flag, junc)
        oracle.append([int(getattr(ez, f)) for f in FIELDS])
        assert np.array_equal(cig[cig_off[k]:cig_off[k + 1]],
                              ez.cigar.astype(np.uint32)), k
    oracle = np.array(oracle, np.int64)
    assert np.array_equal(port[:, :len(FIELDS)], oracle)
    assert port[:, 9].sum() == 0   # exts2 never reaches the end bonus
    assert oracle[:, 8].any() and not oracle[:, 8].all()   # Z-drops
    for k in range(len(exts)):
        if k in JAX_FAULTS:
            assert not np.array_equal(jax_f[k], oracle[k]), k
        else:
            assert jax_f[k].tolist() == oracle[k].tolist(), k
    assert K.EXT_FIELDS[:len(FIELDS)] == FIELDS
