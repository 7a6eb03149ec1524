"""Scale-out paths of the PyTorch port on the CPU: several devices
(mm2_gb_tpu_torch.parallel.mesh), ranks with the port's mergeshards,
the torch.distributed rendezvous, per-part device mapping of a
multi-part index and the --tpu-profile trace.

A list of CPU devices stands in for several cards (each shard takes the
chain twin); the card itself runs the same functions over
[cuda:0, cuda:0] in tests/test_torch_gpu.py and chip_smoke.py.  Outputs
are integers and PAF/SAM bytes: tolerance 0.  Every input is a golden
file of the repo or is made from a numpy seed.
"""

import contextlib
import gzip
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mm2_gb_tpu_torch import cli
from mm2_gb_tpu_torch.models import pipeline as gp
from mm2_gb_tpu_torch.ops import chain_gpu
from mm2_gb_tpu_torch.ops.chain import _chain_dp_scores
from mm2_gb_tpu_torch.parallel import mesh
from mm2_gb_tpu_torch.tools import mergeshards
from mm2_gb_tpu_torch.utils import opts as O
from tests.conftest import golden_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKIP_INF = "--max-chain-skip=2147483647"
SIMREF, SIMREADS = golden_path("simref.fa.gz"), golden_path("simreads.fa.gz")
CG = float(np.float32(float(np.float32(0.8)) * 0.01 * 15))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins gain nothing from intra-op threads at these sizes, and
    under several test workers those threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gold(name):
    with gzip.open(golden_path(name), "rt") as f:
        return f.read()


def _no_pg(s):
    return [line for line in s.splitlines() if not line.startswith("@PG")]


def _run_on_cpu(argv):
    """The --gpu-chain run path (cli._run) on the CPU twins: (rc, out,
    err)."""
    argv, args = cli.parse_args([SKIP_INF, "--gpu-chain", *argv])
    io_, mo = O.set_preset(args.preset)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli._run(args, argv, io_, mo, torch.device("cpu"))
    return rc, out.getvalue(), err.getvalue()


def _anchor_batch(seed=3, n_reads=16):
    """tests/test_chain_tpu.py:171-188's workload: n_reads reads of 40-200
    collinear anchors (span 15), their read bounds."""
    rng = np.random.default_rng(seed)
    bounds, ax_all, ay_all = [0], [], []
    for _ in range(n_reads):
        n = int(rng.integers(40, 200))
        rpos = np.cumsum(rng.integers(1, 10, n))
        qpos = np.maximum.accumulate(np.maximum(rpos + rng.integers(-4, 5, n),
                                                1))
        ax_all.append(rpos.astype(np.uint64))
        ay_all.append((np.uint64(15) << np.uint64(32))
                      | qpos.astype(np.uint64))
        bounds.append(bounds[-1] + n)
    return (np.concatenate(ax_all), np.concatenate(ay_all),
            np.array(bounds, np.int64))


JAX_MULTICHIP = """
import sys
import numpy as np
from mm2_gb_tpu.parallel.mesh import chain_batch_multichip, make_mesh
d = np.load(sys.argv[1])
f, p = chain_batch_multichip(make_mesh(8), d["ax"], d["ay"], d["bounds"],
                             5000, 5000, 500, 5000, float(d["cg"]), 0.0)
np.savez(sys.argv[2], f=f, p=p)
print("MULTICHIP_OK")
"""


def test_chain_batch_multichip_matches_jax_and_oracle(tmp_path):
    """chain_batch_multichip(["cpu"] * 8) equals the JAX package's
    chain_batch_multichip(make_mesh(8)) (a subprocess with 8 host
    devices, as tests/test_chain_tpu.py:157-202 runs it) and the chain
    oracle read by read."""
    ax, ay, bounds = _anchor_batch()
    before = chain_gpu.launches
    fd, pd = mesh.chain_batch_multichip(["cpu"] * 8, ax, ay, bounds, 5000,
                                        5000, 500, 5000, CG, 0.0)
    assert chain_gpu.launches == before   # CPU devices: the twin
    fo, po = np.empty_like(fd), np.empty_like(pd)
    for i in range(bounds.shape[0] - 1):
        s, e = int(bounds[i]), int(bounds[i + 1])
        f1, p1 = _chain_dp_scores(ax[s:e], ay[s:e], 5000, 5000, 500,
                                  2**31 - 1, 5000, np.float32(CG),
                                  np.float32(0.0), False, 1)
        fo[s:e] = f1
        po[s:e] = np.where(p1 >= 0, p1 + s, -1)
    assert np.array_equal(fd, fo) and np.array_equal(pd, po)
    np.savez(tmp_path / "in.npz", ax=ax, ay=ay, bounds=bounds, cg=CG)
    env = dict(os.environ, JAX_PLATFORMS="cpu", MM2TPU_FORCE_CPU="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    r = subprocess.run([sys.executable, "-c", JAX_MULTICHIP,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert "MULTICHIP_OK" in r.stdout, r.stderr[-2000:]
    jx = np.load(tmp_path / "out.npz")
    assert np.array_equal(fd, jx["f"]) and np.array_equal(pd, jx["p"])


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8, 40])
def test_shard_reads_matches_jax(n_dev):
    """The port's _shard_reads is the JAX package's: contiguous shards
    balanced by anchor count, one read each when there are no more reads
    than devices; reads without anchors included."""
    from mm2_gb_tpu.parallel.mesh import _shard_reads as jax_shard_reads
    rng = np.random.default_rng(n_dev)
    for n_reads in (1, 5, 16, 33):
        lens = rng.integers(0, 300, n_reads)
        lens[::4] = 0
        bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        got = mesh._shard_reads(bounds, n_dev)
        assert np.array_equal(got, jax_shard_reads(bounds, n_dev))
        assert got[0] == 0 and got[-1] == n_reads and got.shape == (n_dev + 1,)
        assert (np.diff(got) >= 0).all()


def test_entry_points_default_to_the_card():
    """The mapping entry points run on the CUDA device unless the caller
    names another: map_file_gpu_records, map_batch_gpu and the CLI's
    _run default to "cuda", make_mesh to every CUDA device."""
    import inspect
    for fn in (gp.map_file_gpu_records, gp.map_batch_gpu, cli._run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(mesh.make_mesh).parameters["devices"] \
        .default is None


def test_merge_paf_shards_orders_by_global_read_id():
    """The JAX package's merge of (global read id, line) shards, copied:
    one list in global read order, a read's lines kept together."""
    shards = [[(2, "c1"), (2, "c2"), (5, "f")], [(0, "a"), (3, "d")], []]
    assert mesh.merge_paf_shards(shards) == ["a", "c1", "c2", "d", "f"]


def test_make_mesh():
    """An explicit list may repeat a device or name the CPU; the default
    wants CUDA devices, and without any it raises."""
    assert mesh.make_mesh(devices=["cpu"] * 3) == [torch.device("cpu")] * 3
    assert mesh.make_mesh(2, ["cpu", "cpu", "cpu"]) == \
        [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh()
    with pytest.raises(ValueError, match="no device"):
        mesh.make_mesh(devices=[])


def test_map_file_multichip_matches_golden_and_single_device():
    """map_file_multichip over three CPU devices gives the sim200 golden,
    record for record as the single-device run; every batch is split
    into shards (one dispatch each)."""
    from mm2_gb_tpu_torch.cli import res_regs_out
    from mm2_gb_tpu_torch.models.index import MinimizerIndex
    io_, mo = O.set_preset(None)
    mo.max_chain_skip = 2**31 - 1
    index = MinimizerIndex.from_fasta(SIMREF, io_)
    O.mapopt_update(mo, index)
    outs = []
    for run in (lambda m: mesh.map_file_multichip(
                    index, mo, [SIMREADS], ["cpu"] * 3, m, 2),
                lambda m: gp.map_file_gpu_records(index, mo, [SIMREADS], m,
                                                  2, "cpu")):
        met = gp.GpuMetrics()
        out = io.StringIO()
        for sr, regs in run(met):
            res_regs_out(out, index, mo, sr.rec, regs, sr.rep_len, False,
                         None, 0, 1, [regs])
        outs.append((out.getvalue(), met))
    (multi, mmet), (single, smet) = outs
    assert multi == single == _gold("sim200.skipinf.paf.gz")
    assert mmet.n_batches == smet.n_batches
    assert mmet.n_dispatch == 3 * smet.n_dispatch
    assert mmet.n_pairs == smet.n_pairs and mmet.n_reads == 200


def test_dispatch_and_finish_batch_multichip():
    """dispatch_batch_multichip over two CPU devices, then
    finish_batch_multichip, give each seeded batch's records as the
    single-device _dispatch_batch and _finish_batch do, with one dispatch
    per device."""
    from mm2_gb_tpu_torch.cli import res_regs_out
    from mm2_gb_tpu_torch.models.index import MinimizerIndex
    io_, mo = O.set_preset(None)
    mo.max_chain_skip = 2**31 - 1
    index = MinimizerIndex.from_fasta(golden_path("splitq_ref.fa.gz"), io_)
    O.mapopt_update(mo, index)
    cpu = torch.device("cpu")

    def text(records):
        out = io.StringIO()
        for sr, regs in records:
            res_regs_out(out, index, mo, sr.rec, regs, sr.rep_len, False,
                         None, 0, 1, [regs])
        return out.getvalue()
    n_batches = 0
    for acc in gp._acc_batches(index, mo, [golden_path("splitq_q1.fa.gz")],
                               gp.GpuMetrics()):
        mmet, smet = gp.GpuMetrics(), gp.GpuMetrics()
        multi = text(mesh.finish_batch_multichip(
            index, mo, mesh.dispatch_batch_multichip(index, mo, acc,
                                                     [cpu, cpu], mmet),
            mmet, None, cpu))
        single = text(gp._finish_batch(
            index, mo, gp._dispatch_batch(index, mo, acc, smet, cpu), smet,
            None, cpu))
        assert multi == single and multi.count("\n") >= len(acc) // 2
        assert mmet.n_dispatch == 2 * smet.n_dispatch > 0
        n_batches += 1
    assert n_batches >= 1


def test_cli_tpu_devices_on_cpu():
    """--gpu-devices 3 (the --tpu-devices spelling) through the run path
    on CPU devices: the golden bytes, and -v 3 names the devices used."""
    rc, out, err = _run_on_cpu(["--gpu-devices=3", SIMREF, SIMREADS])
    assert rc == 0 and out == _gold("sim200.skipinf.paf.gz")
    assert "[M::gpu] devices: 3 (cpu, cpu, cpu)" in err


def test_run_devices():
    """--tpu-devices N on a CUDA run takes min(N, the cards PyTorch sees),
    0 all of them; on the CPU, N CPU devices."""
    cpu = torch.device("cpu")
    assert cli.run_devices(3, cpu) == [cpu] * 3
    assert cli.run_devices(0, cpu) == [cpu]
    n = torch.cuda.device_count()
    cuda = torch.device("cuda")
    assert len(cli.run_devices(0, cuda)) == n
    assert len(cli.run_devices(64, cuda)) == min(64, n)


def _ranks(tmp_path, flags, query=SIMREADS, ref=SIMREF, name="mh"):
    """Run the two ranks of --tpu-nproc 2 on the CPU; the shard prefix."""
    pre = str(tmp_path / name)
    for rank in ("0", "1"):
        rc, out, err = _run_on_cpu(["--tpu-nproc", "2", "--tpu-rank", rank,
                                    "-o", pre, *flags, ref, query])
        assert rc == 0, err[-2000:]
        assert out == ""
    return pre


def _merge(pre):
    """The port's `mergeshards PRE 2`: (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mergeshards.main([pre, "2"])
    return rc, out.getvalue(), err.getvalue()


def _merged_text(pre, n):
    out = io.StringIO()
    assert mergeshards.merge(pre, n, out) == 0
    return out.getvalue()


def test_two_ranks_merge_to_the_single_run(tmp_path):
    """Two ranks through the port's rank function (cli._run_gpu_multihost
    on CPU tensors) and its mergeshards: the sim200 golden.  Each shard
    holds its rank's round-robin reads; every idx ends with #done and
    counts the file's 200 records in #file."""
    pre = _ranks(tmp_path, [])
    assert _merged_text(pre, 2) == _gold("sim200.skipinf.paf.gz")
    for rank in (0, 1):
        idx = open(f"{pre}.shard{rank}.idx").read().splitlines()
        assert idx[-1].startswith("#done\t") and idx[-2] == "#file\t0\t200"
        gidx = [int(line.split("\t")[1]) for line in idx[:-2]]
        assert gidx == list(range(rank, 200, 2))
        assert int(idx[-1].split("\t")[1]) == len(gidx)


def test_two_ranks_sam_header_on_rank_0_only(tmp_path):
    """-a: rank 0's shard starts with the SAM header (a sort-first (-1, -1)
    idx record), rank 1's holds none; the merge equals the single-process
    SAM but for @PG (which holds each run's command) and carries the
    header once."""
    single_rc, single, _err = _run_on_cpu(["-a", golden_path(
        "splitq_ref.fa.gz"), golden_path("splitq_q1.fa.gz")])
    assert single_rc == 0
    pre = _ranks(tmp_path, ["-a"], golden_path("splitq_q1.fa.gz"),
                 golden_path("splitq_ref.fa.gz"))
    body0 = open(pre + ".shard0").read()
    body1 = open(pre + ".shard1").read()
    assert body0.startswith("@SQ") and "\n@PG\t" in body0
    assert not any(line.startswith("@") for line in body1.splitlines())
    assert open(pre + ".shard0.idx").readline().startswith("-1\t-1\t")
    merged = _merged_text(pre, 2)
    assert _no_pg(merged) == _no_pg(single)
    assert merged.count("\n@PG\t") == 1


def test_merge_refuses_truncated_or_unfinished_shards(tmp_path):
    """A truncated shard body and a missing #done sentinel (a crashed
    rank) make the port's mergeshards fail, before it writes anything."""
    pre = _ranks(tmp_path, ["-c"], golden_path("splitq_q1.fa.gz"),
                 golden_path("splitq_ref.fa.gz"))
    body = open(pre + ".shard1").read()
    with open(pre + ".shard1", "w") as f:
        f.write(body[:len(body) // 2])
    rc, out, err = _merge(pre)
    assert rc == 1 and out == "" and ("truncated" in err
                                      or "trailing" in err)
    with open(pre + ".shard1", "w") as f:
        f.write(body)
    idx = open(pre + ".shard1.idx").read().splitlines()
    with open(pre + ".shard1.idx", "w") as f:
        f.write("\n".join(idx[:-1]) + "\n")
    rc, out, err = _merge(pre)
    assert rc == 1 and out == "" and "sentinel" in err


def test_mergeshards_trailing_loss_and_total_disagreement(tmp_path):
    """The JAX package's case (tests/test_chain_tpu.py:569) against the
    port's copy: per-file #file totals let the merge find a trailing loss
    and ranks that disagree on a file's read count."""
    def write_rank(rank, recs, total, done=None):
        body, idx = [], []
        for fi, gidx in recs:
            body.append(f"read{gidx}\tline\n")
            idx.append(f"{fi}\t{gidx}\t1")
        idx.append(f"#file\t0\t{total}")
        idx.append(f"#done\t{done if done is not None else len(recs)}")
        (tmp_path / f"mh.shard{rank}").write_text("".join(body))
        (tmp_path / f"mh.shard{rank}.idx").write_text("\n".join(idx) + "\n")

    def merge():
        return subprocess.run(
            [sys.executable, "-m", "mm2_gb_tpu_torch.tools.mergeshards",
             str(tmp_path / "mh"), "2"], capture_output=True, text=True,
            cwd=ROOT, timeout=120)
    write_rank(0, [(0, 0), (0, 2)], 4)
    write_rank(1, [(0, 1), (0, 3)], 4)
    ok = merge()
    assert ok.returncode == 0
    assert ok.stdout.splitlines() == [f"read{i}\tline" for i in range(4)]
    # trailing loss: rank 1 saw a truncated copy of the file
    write_rank(1, [(0, 1)], 2)
    bad = merge()
    assert bad.returncode != 0
    assert "disagree" in bad.stderr or "missing" in bad.stderr
    # the sentinel disagrees with the records
    write_rank(1, [(0, 1), (0, 3)], 4, done=3)
    bad = merge()
    assert bad.returncode != 0 and "sentinel says 3" in bad.stderr


def test_rank_run_needs_output_prefix_and_device_chaining(capsys):
    """--tpu-nproc without -o, and a rank whose run maps on the host
    (fragment mode), exit 1 with the JAX package's messages."""
    rc, out, err = _run_on_cpu(["--tpu-nproc", "2", SIMREF, SIMREADS])
    assert rc == 1 and out == "" and "needs -o OUT" in err
    rc, out, err = _run_on_cpu(["--tpu-nproc", "2", "-o", "x", "-x", "sr",
                                "--frag=yes", SIMREF,
                                golden_path("pe_1.fq.gz"),
                                golden_path("pe_2.fq.gz")])
    assert rc == 1 and "requires --tpu-chain" in err


RANK = """
import sys
import torch
torch.set_num_threads(1)
from mm2_gb_tpu_torch import cli
from mm2_gb_tpu_torch.utils import opts as O
argv, args = cli.parse_args(sys.argv[1:])
io_, mo = O.set_preset(args.preset)
sys.exit(cli._run(args, argv, io_, mo, torch.device("cpu")))
"""


def test_tpu_coord_rendezvous_of_two_ranks(tmp_path):
    """Two concurrent rank processes meet in the torch.distributed
    rendezvous of --gpu-coord 127.0.0.1:<free port> (gloo), each map
    their share and leave; the merge is the single-process output."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pre = str(tmp_path / "co")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, SKIP_INF, "--gpu-chain", "-c",
         "--gpu-nproc", "2", "--gpu-rank", str(rank), "--gpu-coord",
         f"127.0.0.1:{port}", "-o", pre, golden_path("splitq_ref.fa.gz"),
         golden_path("splitq_q1.fa.gz")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    try:
        res = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_out, err) in zip(procs, res):
        assert p.returncode == 0, err[-2000:]
    rc, single, _err = _run_on_cpu(["-c", golden_path("splitq_ref.fa.gz"),
                                    golden_path("splitq_q1.fa.gz")])
    assert rc == 0 and single.count("\n") >= 6
    assert _merged_text(pre, 2) == single


@pytest.mark.parametrize("flags,ref,query,n_reads,golden", [
    (["-c", "-I", "120k", "--split-prefix", "SP"], "simref.fa.gz",
     "simreads.fa.gz", 200, "sim200.split120k.c.paf.gz"),
    (["-c", "-I", "20k"], "multi3.fa.gz", "multi3_q.fa.gz", 3,
     "multi3.noI.c.paf.gz"),
    (["-c", "-I", "20k", "--split-prefix", "SP"], "multi3.fa.gz",
     "multi3_q.fa.gz", 3, "multi3.split.c.paf.gz")],
    ids=["sim200_split120k", "multi3_noI", "multi3_split"])
def test_per_part_device_mapping(flags, ref, query, n_reads, golden,
                                 tmp_path, monkeypatch):
    """A multi-part index and one query file map part by part through the
    device pipeline (the chain twin on CPU tensors; no host chaining
    warning) and give the goldens of the JAX package's
    tests/test_e2e_paf.py:460-479."""
    batches = []
    dispatch = gp._dispatch_batch

    def counted(*a, **kw):
        batches.append(len(a[2]))
        return dispatch(*a, **kw)
    monkeypatch.setattr(gp, "_dispatch_batch", counted)
    flags = [str(tmp_path / "sp") if f == "SP" else f for f in flags]
    rc, out, err = _run_on_cpu([*flags, golden_path(ref), golden_path(query)])
    assert rc == 0
    assert out == _gold(golden)
    assert "falling back" not in err
    # every read went through a device batch once per part
    assert sum(batches) >= n_reads and sum(batches) % n_reads == 0


def test_tpu_profile_writes_a_trace(tmp_path):
    """--gpu-profile DIR: a Chrome trace of the mapping run in DIR (CPU
    activities here; CUDA ones too on the card), and the JAX package's
    closing line."""
    import json
    prof = tmp_path / "prof"
    rc, out, err = _run_on_cpu(["--gpu-profile", str(prof), "-c",
                                golden_path("multi3.fa.gz"),
                                golden_path("multi3_q.fa.gz")])
    assert rc == 0 and out == _gold("multi3.noI.c.paf.gz")
    assert f"[M::profile] trace written to {prof}" in err
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
