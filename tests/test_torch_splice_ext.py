"""Splice extensions of the PyTorch port (mm2_gb_tpu_torch.ops.ksw2s_gpu,
the extension mode of the exts2 kernel) on the CPU: the plain twins of
the exts2_ext kernel and of the intron backtrack from per-fill starts,
driven through exts2_ext_batch, against the port's ksw2_splice.exts2 in
its native and its pure-Python form, and against the JAX package's
ksw2_splice.exts2 (the semantics of exts2_fwd_tpu(track_h=True); the
Pallas kernel itself runs in tests/test_torch_splice_ext_pallas.py).
Every Extz field and the CIGAR are integers: tolerance 0.  Every input
is made from a numpy seed.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (_pack_splice_ext, ext_result_err, splice_ext_oracle,
                        splice_ext_pairs, splice_ext_workloads)
from mm2_gb_tpu.ops import ksw2 as jksw2
from mm2_gb_tpu.ops import ksw2_splice as JS
from mm2_gb_tpu_torch.ops import ksw2_gpu as K
from mm2_gb_tpu_torch.ops import ksw2s_gpu as KS
from mm2_gb_tpu_torch.utils import opts as O

EXTO = jksw2.KSW_EZ_EXTZ_ONLY
FOR, REV, FLANK = (jksw2.KSW_EZ_SPLICE_FOR, jksw2.KSW_EZ_SPLICE_REV,
                   jksw2.KSW_EZ_SPLICE_FLANK)
RIGHT, REVC = jksw2.KSW_EZ_RIGHT, jksw2.KSW_EZ_REV_CIGAR

WORKLOADS = list(splice_ext_workloads(n_pairs=24, max_intron=500,
                                      long_intron=1500, scratch=False))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins gain nothing from intra-op threads at these sizes, and
    under several test workers those threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(preset="splice"):
    return KS.splice_params(O.set_preset(preset)[1])


@pytest.mark.parametrize("name,meta,qb,tb,jb,fl,zd,prm", WORKLOADS,
                         ids=[w[0] for w in WORKLOADS])
def test_twins_match_ksw2_splice_exts2(name, meta, qb, tb, jb, fl, zd, prm):
    """The smoke's splice extension workloads (read ends across introns,
    every splice variant with and without EXTZ_ONLY, RIGHT|REV_CIGAR, BED
    junctions, a junction bonus that wraps int8, N bases, unrelated
    pairs, Z-drop hits, the mat gate) through exts2_ext_batch on the
    twins: every Extz field and the CIGAR equal the port's
    ksw2_splice.exts2 (the native kit) and the JAX package's."""
    before = (KS.ext_launches, K.backtrack_launches)
    st = K.FillStats()
    got = KS.exts2_ext_batch(meta, qb, tb, jb, fl, zd, prm, "cpu", st)
    assert ext_result_err(got, splice_ext_oracle(meta, qb, tb, jb, fl, zd,
                                                 prm)) == 0
    assert ext_result_err(got, splice_ext_oracle(meta, qb, tb, jb, fl, zd,
                                                 prm, JS.exts2)) == 0
    assert st.ext_fills == meta.shape[0]
    if name == "mat_gate":
        assert prm.host_only and st.ext_host_fills == st.ext_fills
    else:
        assert st.ext_host_fills == 0 and st.ext_chunks == 1
        assert st.ext_cells == int((meta[:, 0] * meta[:, 1]).sum())
    if name in ("splice", "splice:hq"):
        assert got[0][:, 8].any() and not got[0][:, 8].all()   # Z-drops
        assert not got[0][:, 9].any()                            # reach_end
    # CPU tensors take the twins: no kernel launch is counted
    assert (KS.ext_launches, K.backtrack_launches) == before


def test_twins_match_the_pure_python_oracle(monkeypatch):
    """The same against the port's ksw2_splice.exts2 without the native
    kit (its NumPy row loop, the `_row_max` and `_apply_zdrop` the kernel
    mirrors)."""
    _name, meta, qb, tb, jb, fl, zd, prm = WORKLOADS[0]
    got = KS.exts2_ext_batch(meta, qb, tb, jb, fl, zd, prm, "cpu")
    monkeypatch.setenv("MM2TPU_NO_NATIVE", "1")
    assert ext_result_err(got, splice_ext_oracle(meta, qb, tb, jb, fl, zd,
                                                 prm)) == 0


@pytest.mark.parametrize("flag", [EXTO | FOR, EXTO | FOR | RIGHT | REVC,
                                  FOR | REV | FLANK, FOR | RIGHT])
def test_backtrack_start_rules(flag):
    """ksw2_splice.py:284-291: without EXTZ_ONLY and without a Z-drop the
    CIGAR runs from (tlen-1, qlen-1); otherwise from (max_t, max_q); a
    fill that never scores above 0 has no CIGAR.  The twin's starts
    (ext columns 10-11) show which rule it took."""
    rng = np.random.default_rng(flag)
    exts = [(q, t, flag, j, z) for q, t, _f, j, z in
            splice_ext_pairs(rng, 16, 400)]
    meta, qb, tb, jb, fl, zd = _pack_splice_ext(exts)
    prm = _params()
    qo = torch.tensor(np.concatenate([[0], np.cumsum(meta[:, 0])[:-1]]))
    to = torch.tensor(np.concatenate([[0], np.cumsum(meta[:, 1])[:-1]]))
    jo = torch.tensor(np.where(meta[:, 2] > 0, np.concatenate(
        [[0], np.cumsum(meta[:, 2])[:-1]]), -1))
    ql = torch.tensor(meta[:, 0], dtype=torch.int32)
    tl = torch.tensor(meta[:, 1], dtype=torch.int32)
    pb = K.p_bound(meta[:, 0], meta[:, 1], meta[:, 0] + meta[:, 1])
    po = torch.tensor(np.concatenate([[0], np.cumsum(pb)[:-1]]))
    ext, _p = KS.exts2_ext_torch(
        torch.from_numpy(qb), torch.from_numpy(tb), torch.from_numpy(jb), qo,
        to, jo, ql, tl, torch.tensor(fl, dtype=torch.int32),
        torch.tensor(zd, dtype=torch.int32), po, int(pb.sum()), prm)
    ext = ext.numpy()
    for k in range(meta.shape[0]):
        dropped, (mx, max_t, max_q) = ext[k, 8], ext[k, 1:4]
        if not dropped and not flag & EXTO:
            want = (meta[k, 1] - 1, meta[k, 0] - 1)
        elif max_t >= 0 and max_q >= 0:
            want = (max_t, max_q)
        else:
            want = (-1, -1)
        assert tuple(ext[k, 10:12]) == want, k
        assert ext[k, 9] == 0 and (mx > 0) == (max_t >= 0)


def test_zdrop_takes_no_gap_extension():
    """Splice Z-drop compares max - H with zdrop alone (gap extension 0,
    ksw2_splice.py:255): on a query whose second half is unrelated, the
    twin drops where the oracle does, at the same row maximum, for every
    Z-drop."""
    rng = np.random.default_rng(77)
    t = rng.integers(0, 4, 900).astype(np.uint8)
    q = np.concatenate([t[:300], rng.integers(0, 4, 300).astype(np.uint8)])
    prm = _params()
    exts = [(q, t, EXTO | FOR, None, z) for z in (10, 25, 60, 150)]
    meta, qb, tb, jb, fl, zd = _pack_splice_ext(exts)
    got = KS.exts2_ext_batch(meta, qb, tb, jb, fl, zd, prm, "cpu")
    want = splice_ext_oracle(meta, qb, tb, jb, fl, zd, prm)
    assert ext_result_err(got, want) == 0
    assert got[0][:, 8].all()
    # the maximum lies at the end of the related half
    assert (got[0][:, 2] >= 290).all() and (got[0][:, 3] >= 290).all()


def test_ext_wrappers_refuse_what_the_kernel_does_not_take():
    z8 = torch.zeros(4, dtype=torch.uint8)
    i64 = torch.zeros(1, dtype=torch.int64)
    i32 = torch.ones(1, dtype=torch.int32)
    prm = _params()
    with pytest.raises(ValueError, match="exts2_ext: zdrop"):
        KS.exts2_ext(z8, z8, z8, i64, i64, i64, i32, i32, i32, i64, i64, 64,
                     prm)
    gate = KS.splice_params_from(jksw2.gen_simple_mat(5, 1, 40, 1), 2, 1,
                                 32, 9, 9)
    with pytest.raises(ValueError, match="host route"):
        KS.exts2_ext(z8, z8, z8, i64, i64, i64, i32, i32, i32, i32, i64, 64,
                     gate)
    meta = np.array([[2, 2, 0]], np.int64)
    two = np.zeros(2, np.uint8)
    for flags in ([jksw2.KSW_EZ_APPROX_MAX | FOR],
                  [EXTO | jksw2.KSW_EZ_APPROX_DROP]):
        with pytest.raises(ValueError, match="unsupported flags"):
            KS.exts2_ext_batch(meta, two, two, two[:0], np.array(flags),
                               np.array([-1]), prm, "cpu")


def test_host_route_is_counted():
    """An empty side takes ksw2_splice.exts2 on the host (counted in
    ext_host_fills); options past the gate send every extension there."""
    rng = np.random.default_rng(9)
    t = rng.integers(0, 4, 300).astype(np.uint8)
    exts = [(t[:120].copy(), t, EXTO | FOR, None, 200),
            (np.empty(0, np.uint8), t, EXTO | FOR, None, 200),
            (t[:50].copy(), np.empty(0, np.uint8), FOR, None, -1),
            (t[100:200].copy(), t[90:210].copy(), EXTO | FOR | RIGHT | REVC,
             rng.integers(0, 16, 120).astype(np.uint8), 40)]
    packed = _pack_splice_ext(exts)
    for prm, n_host in ((_params(), 2),
                        (KS.splice_params_from(jksw2.gen_simple_mat(
                            5, 1, 2, 1), 2, 1, 3, 9, 9), 4)):
        st = K.FillStats()
        got = KS.exts2_ext_batch(*packed, prm, "cpu", st)
        assert ext_result_err(got, splice_ext_oracle(*packed, prm)) == 0
        assert (st.ext_fills, st.ext_host_fills) == (4, n_host)
        assert st.fills == 0   # the gap-fill counters stay untouched


def test_chunks_split_by_budget(monkeypatch):
    """A small chunk budget splits a batch into several launches of the
    twins; the results do not change."""
    from mm2_gb_tpu_torch.utils import gpucfg
    _name, meta, qb, tb, jb, fl, zd, prm = WORKLOADS[2]
    want = splice_ext_oracle(meta, qb, tb, jb, fl, zd, prm)
    monkeypatch.setattr(gpucfg, "CPU_FILL_CHUNK_BYTES", 400_000)
    st = K.FillStats()
    got = KS.exts2_ext_batch(meta, qb, tb, jb, fl, zd, prm, "cpu", st)
    assert st.ext_chunks >= 3
    assert ext_result_err(got, want) == 0


def test_ext_ring_lanes_and_scratch():
    """The extension rings add the int32 H ring to the fill kernel's
    thirteen byte rings; a read end past ~940 bases keeps them in global
    scratch."""
    ring = KS.ext_ring_bytes(np.array([900, 1100]), np.array([3000, 3000]))
    assert ring.tolist() == [17 * 1024 + 16, 17 * 2048 + 16]
    assert (ring > KS.EXT_SMEM_MAX).tolist() == [False, True]


def test_every_kernel_entry_has_its_ctypes_signature():
    """Each `lib.mm2_*` call of the port's wrappers has a ctypes signature
    in utils/kernels.py with as many arguments as the call passes and as
    the C function in csrc/*.cu declares (without one, ctypes would pass
    every pointer as a 32-bit int: a fault only the card shows)."""
    import ast
    import glob
    import os
    import re
    from mm2_gb_tpu_torch.utils import kernels
    pkg = os.path.dirname(os.path.dirname(kernels.__file__))
    c_args = {}
    for path in glob.glob(os.path.join(pkg, "csrc", "*.cu")):
        src = open(path).read()
        for m in re.finditer(r"^int (mm2_\w+)\(([^)]*)\)", src, re.M):
            c_args[m.group(1)] = len([a for a in m.group(2).split(",")
                                      if a.strip() not in ("", "void")])
    calls = {}
    for path in glob.glob(os.path.join(pkg, "ops", "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr.startswith("mm2_")):
                calls[node.func.attr] = len(node.args)
    assert "mm2_exts2_ext" in calls and "mm2_exts2_fill" in calls
    assert set(kernels._SIGNATURES) == set(c_args)
    for name, n in calls.items():
        assert len(kernels._SIGNATURES[name]) == n == c_args[name], name
