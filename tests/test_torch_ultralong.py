"""The over50k path on the CPU: ultra-long reads over a repeat-rich
reference, the anchor cap's spill, the port's device configs.

A small repeat-rich reference (`simulate.random_repetitive_reference`,
1.5 Mbp with four tandem arrays of 10-15 copies of a 300-800 bp unit)
and reads of 55-60 kb that start 20 kb before an array and cross it.
Every query copy of an array's unit hits every reference copy, so the
read's one long segment has windows of up to max_iter = 5,000 anchors,
past the chain kernel's shared-memory ring: `chain_gpu.segment_shape`
gives it the block class with its window in global memory
(block_global), the class the over50k configuration exists for.

- The port's device route on the twins (`pipeline.map_file_gpu(...,
  device="cpu")`) gives the JAX package's host-path records for the same
  reads, and its chain launches hold a block_global segment.
- A read whose anchors pass `max_anchors_batch` maps alone in its batch
  (`pipeline._acc_batches` spills the batch before and after it), with
  the records of the uncapped run.
- Each `mm2_gb_tpu_torch/configs/*.json` loads through `load_gpu_config`
  to positive caps that `derive_caps` leaves alone, ships with the
  package (setup.py's package_data), and `--gpu-cfg h100_default.json`
  maps sim200 to its golden on the twins.
"""

import ast
import fnmatch
import gzip
import json
import os

import numpy as np
import pytest
import torch

from mm2_gb_tpu.models.index import MinimizerIndex as JIndex
from mm2_gb_tpu.models.mapper import map_frag
from mm2_gb_tpu.utils import opts as JO
from mm2_gb_tpu.utils.paf import write_paf as jpaf
from mm2_gb_tpu_torch import cli
from mm2_gb_tpu_torch.models import pipeline as gp
from mm2_gb_tpu_torch.models.index import MinimizerIndex
from mm2_gb_tpu_torch.ops import chain_gpu as G
from mm2_gb_tpu_torch.utils import gpucfg
from mm2_gb_tpu_torch.utils import opts as O
from mm2_gb_tpu_torch.utils.simulate import (random_repetitive_reference,
                                             simulate_read)
from tests.conftest import golden_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKIP_INF = "--max-chain-skip=2147483647"
REF_LEN, N_ARRAYS, REF_SEED = 1_500_000, 4, 5
CONFIGS = sorted(f for f in os.listdir(gpucfg.CONFIG_DIR)
                 if f.endswith(".json"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins gain nothing from intra-op threads at these sizes, and
    under several test workers those threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _array_starts(length, seed, n_arrays):
    """Where random_repetitive_reference planted its arrays: its draws
    replayed in their order (the bases, then per array the unit length,
    copies, unit, divergence and start)."""
    rng = np.random.default_rng(seed)
    rng.choice(np.frombuffer(b"ACGT", np.uint8), length)
    starts = []
    for _ in range(n_arrays):
        unit_len = int(rng.integers(300, 800))
        copies = int(rng.integers(10, 16))
        rng.integers(0, 4, unit_len)
        mut = rng.random(unit_len * copies) < 0.005
        rng.integers(0, 4, int(mut.sum()))
        starts.append(int(rng.integers(0, length - unit_len * copies - 1)))
    return sorted(starts)


@pytest.fixture(scope="module")
def ul(tmp_path_factory):
    """The reference, its reads (three crossing an array, two short ones
    away from the arrays), their FASTA, both packages' indexes and
    options at -x map-ont with max_chain_skip = 2**31 - 1, and the
    port's device route on the twins over them (map_file_gpu): its PAF
    lines read by read and the chain launches' operands."""
    ref = random_repetitive_reference(REF_LEN, seed=REF_SEED,
                                      n_arrays=N_ARRAYS)
    arrays = _array_starts(REF_LEN, REF_SEED, N_ARRAYS)
    reads = [(f"x{i}", simulate_read(ref, a - 20_000, 55_000 + 2_500 * i,
                                     rev=i == 1, seed=40 + i))
             for i, a in enumerate(arrays[:3])]
    gaps = [a + 30_000 for a in arrays[:2]]
    reads[1:1] = [("s0", simulate_read(ref, gaps[0], 6_000, seed=50))]
    reads.append(("s1", simulate_read(ref, gaps[1], 4_000, rev=True,
                                      seed=51)))
    d = tmp_path_factory.mktemp("ultralong")
    qpath = str(d / "q.fa")
    with open(qpath, "w") as f:
        f.write("".join(f">{n}\n{s}\n" for n, s in reads))
    io_, mo = O.set_preset("map-ont")
    mo.max_chain_skip = 2**31 - 1
    index = MinimizerIndex.from_strings([ref], io_, names=["chr1"])
    O.mapopt_update(mo, index)
    jio, jmo = JO.set_preset("map-ont")
    jmo.max_chain_skip = 2**31 - 1
    jindex = JIndex.from_strings([ref], jio, names=["chr1"])
    JO.mapopt_update(jmo, jindex)
    launches = []
    chain = G.chain_segments

    def rec(*a, **kw):
        launches.append(a)
        return chain(*a, **kw)
    G.chain_segments = rec
    try:
        lines = list(gp.map_file_gpu(index, mo, [qpath], device="cpu"))
    finally:
        G.chain_segments = chain
    paf = {n: [x for x in lines if x.split("\t", 1)[0] == n]
           for n, _s in reads}
    assert sum(map(len, paf.values())) == len(lines)
    return dict(reads=reads, qpath=qpath, index=index, mo=mo, jindex=jindex,
                jmo=jmo, paf=paf, launches=launches, dir=d)


def _records(index, mo, qpath, metrics=None):
    """{read name: its PAF lines} of the device route on the twins."""
    from mm2_gb_tpu_torch.utils.paf import write_paf
    out = {}
    for sr, regs in gp.map_file_gpu_records(index, mo, [qpath], metrics,
                                            device="cpu"):
        out[sr.rec.name] = [write_paf(r, sr.rec.name, sr.rec.length, index,
                                      mo.flag, sr.rep_len) for r in regs]
    return out


def test_the_twins_route_gives_the_jax_host_path_records(ul):
    """Read by read, the port's device route on the twins
    (map_file_gpu) writes the JAX package's host mapper's (map_frag, on
    its own index) PAF lines; every read maps."""
    for name, seq in ul["reads"]:
        host = map_frag(ul["jindex"], ul["jmo"], [seq], name)
        want = [jpaf(r, name, len(seq), ul["jindex"], ul["jmo"].flag,
                     host.rep_len) for r in host.regs]
        assert ul["paf"][name] == want
        assert want


def test_the_run_gives_a_block_global_segment(ul):
    """The run's chain launch puts a segment past RING_SLOTS anchors whose
    widest range passes RING_SLOTS - CHAIN_THREADS in the block class,
    with its window in global memory."""
    assert len(ul["launches"]) == 1
    _x, _y, rng, s, e = ul["launches"][0]
    sh = G.segment_shape(s.numpy(), e.numpy(), rng.numpy())
    assert sh.n_global >= 1
    glob = sh.work[:sh.n_long][sh.work[:sh.n_long, 3] == 0]
    assert (glob[:, 1] - glob[:, 0] > G.RING_SLOTS).all()
    assert (glob[:, 2] + G.CHAIN_THREADS > G.RING_SLOTS).all()
    assert int(rng.max()) == ul["mo"].max_chain_iter


def test_a_read_over_the_anchor_cap_maps_alone(ul, monkeypatch):
    """With max_anchors_batch below a long read's anchors, the batcher
    spills the short read before it and the one after it, so the long
    read is chained in a batch of its own; every read's records equal
    the uncapped run's."""
    names = ["s0", "x1", "s1"]
    seqs = dict(ul["reads"])
    qpath = str(ul["dir"] / "capped.fa")
    with open(qpath, "w") as f:
        f.write("".join(f">{n}\n{seqs[n]}\n" for n in names))
    batches = []
    dispatch = gp._dispatch_batch

    def rec(index, opt, acc, *a, **kw):
        batches.append([(sr.rec.name, sr.ax.shape[0]) for sr in acc])
        return dispatch(index, opt, acc, *a, **kw)
    monkeypatch.setattr(gp, "_dispatch_batch", rec)
    monkeypatch.setattr(gpucfg, "_current", gpucfg.GpuConfig(
        max_anchors_batch=5_000, caps_explicit=True))
    met = gp.GpuMetrics()
    got = _records(ul["index"], ul["mo"], qpath, met)
    assert [[n for n, _a in b] for b in batches] == [[n] for n in names]
    assert batches[1][0][1] > 5_000 > batches[0][0][1] + batches[2][0][1]
    assert met.n_spills == 2
    assert got == {n: ul["paf"][n] for n in names}


@pytest.mark.parametrize("name", CONFIGS)
def test_each_config_loads_to_pinned_caps(name, monkeypatch):
    """A config of the port's own loads to positive caps with
    caps_explicit, which derive_caps then leaves alone even on a card
    with little free memory; it names its read-length class and holds no
    TPU-only field."""
    path = os.path.join(gpucfg.CONFIG_DIR, name)
    with open(path) as f:
        data = json.load(f)
    assert set(data) == {"_comment", "max_anchors_batch", "max_reads_batch"}
    cfg = gpucfg.load_gpu_config(path)
    assert cfg.caps_explicit
    assert (cfg.max_anchors_batch, cfg.max_reads_batch) == (
        data["max_anchors_batch"], data["max_reads_batch"])
    assert min(cfg.max_anchors_batch, cfg.max_reads_batch) > 0
    monkeypatch.setattr(gpucfg, "_current", cfg)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (1 << 20,
                                                               1 << 30))
    gpucfg.derive_caps(torch.device("cuda"), 0)
    assert gpucfg.current_config().max_anchors_batch == \
        data["max_anchors_batch"]
    if name == "h100_default.json":
        d = gpucfg.GpuConfig()
        assert (cfg.max_anchors_batch, cfg.max_reads_batch) == (
            d.max_anchors_batch, d.max_reads_batch)
    else:
        assert name.split("_")[1].split(".")[0] in data["_comment"]


def test_gpu_cfg_default_maps_sim200_to_its_golden(capsys):
    """`--gpu-chain --gpu-cfg configs/h100_default.json` through cli._run
    on the twins gives the sim200 golden and installs the file's caps."""
    old = gpucfg._current
    try:
        argv, args = cli.parse_args([
            SKIP_INF, "--gpu-chain", "--gpu-cfg",
            os.path.join(gpucfg.CONFIG_DIR, "h100_default.json"),
            golden_path("simref.fa.gz"), golden_path("simreads.fa.gz")])
        io_, mo = O.set_preset(args.preset)
        assert cli._run(args, argv, io_, mo, torch.device("cpu")) == 0
        with gzip.open(golden_path("sim200.skipinf.paf.gz"), "rt") as f:
            assert capsys.readouterr().out == f.read()
        assert gpucfg.current_config() == gpucfg.GpuConfig(caps_explicit=True)
    finally:
        gpucfg._current = old


def test_package_data_ships_the_configs_and_kernel_sources():
    """setup.py's package_data globs match every config and every kernel
    source and header of the port, so an installed package builds its
    kernels and finds its configs."""
    with open(os.path.join(ROOT, "setup.py")) as f:
        tree = ast.parse(f.read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", "") == "setup")
    data = ast.literal_eval(next(k.value for k in call.keywords
                                 if k.arg == "package_data"))
    globs = data["mm2_gb_tpu_torch"]
    pkg = os.path.join(ROOT, "mm2_gb_tpu_torch")
    files = [os.path.relpath(os.path.join(d, f), pkg)
             for sub in ("configs", "csrc")
             for d, _dirs, fs in os.walk(os.path.join(pkg, sub))
             for f in fs if not f.endswith((".py", ".pyc"))]
    assert any(f.startswith("configs") for f in files)
    assert any(f.endswith(".cuh") for f in files)
    for f in files:
        assert any(fnmatch.fnmatch(f, g) for g in globs), f

