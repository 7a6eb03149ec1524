"""The port's spans (mm2_gb_tpu_torch.utils.timeline.span) in its mapping
loop, on CPU tensors (the kernels' plain twins).

Without a profiler a span only times its stage for the counter it feeds,
and is kept only where it asks to be (`always`, as `kernels.load`).
Under a torch profiler every span is kept, on the main, dispatch and
pool threads, with its batch id and parent; each GpuMetrics and
FillStats timer equals the sum of the spans that feed it; and the main
thread's spans are record_function ranges of the exported trace, on the
trace's clock.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from mm2_gb_tpu_torch import cli
from mm2_gb_tpu_torch.models import pipeline as gp
from mm2_gb_tpu_torch.models.index import MinimizerIndex
from mm2_gb_tpu_torch.utils import gpucfg, timeline
from mm2_gb_tpu_torch.utils import opts as O
from mm2_gb_tpu_torch.utils.simulate import random_reference, simulate_readset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the spans that feed each GpuMetrics timer (t_finish: finish.batch less
# its chain.readback) and FillStats.batch_s
FEEDS = {"t_seed": "seed.chunk", "t_range": "dispatch.range",
         "t_pack": "dispatch.pack", "t_dispatch": "dispatch.upload",
         "t_wait": "chain.readback", "t_collect": "fill.collect",
         "t_table": "fill.table"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(tmp, qstrand=False):
    """Index, `-c --gpu-align` options (the Python fill session with
    --qstrand, else the C++ aligner's) and a query file of four reads."""
    ref = random_reference(30_000, seed=51)
    reads = simulate_readset(ref, 4, 1_200, 2_000, seed=52)
    io_, mo = O.set_preset(None)
    mo.max_chain_skip = 2**31 - 1
    index = MinimizerIndex.from_strings([ref], io_, names=["c"])
    O.mapopt_update(mo, index)
    mo.flag |= O.MM_F_CIGAR | O.MM_F_OUT_CG | O.MM_F_TPU_ALIGN
    if qstrand:
        mo.flag |= O.MM_F_QSTRAND
    path = os.path.join(tmp, "q.fa")
    with open(path, "w") as f:
        f.writelines(f">{n}\n{s}\n" for n, s in reads)
    return index, mo, path


def _map(index, mo, path, metrics, n_threads=2):
    """map_file_gpu_records in batches of about two reads, each read's
    records written through cli.res_regs_out."""
    old = gpucfg._current
    gpucfg._current = gpucfg.GpuConfig(max_anchors_batch=350)
    try:
        out = io.StringIO()
        n = 0
        for sr, regs in gp.map_file_gpu_records(index, mo, [path], metrics,
                                                n_threads, device="cpu"):
            cli.res_regs_out(out, index, mo, sr.rec, regs, sr.rep_len,
                             False, None, 0, 1, [regs])
            n += 1
        return n
    finally:
        gpucfg._current = old


@pytest.fixture(scope="module", params=["native", "python"])
def traced(request, tmp_path_factory):
    """A -t 2 run with gap fills under a CPU torch.profiler: its metrics,
    its spans, the main thread's id and the exported trace."""
    from torch.profiler import ProfilerActivity, profile
    tmp = str(tmp_path_factory.mktemp("trace"))
    index, mo, path = _setup(tmp, qstrand=request.param == "python")
    timeline.spans()   # what earlier tests left
    met = gp.GpuMetrics()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        n_reads = _map(index, mo, path, met)
    finally:
        prof.stop()
    trace = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        doc = json.load(f)
    return dict(metrics=met, spans=timeline.spans(), n_reads=n_reads,
                main=threading.get_ident(), trace=doc)


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _total(xs):
    """xs added one by one, as a counter adds them (sum() compensates)."""
    t = 0.0
    for x in xs:
        t += x
    return t


def test_no_profiler_keeps_only_spans_outside_the_loop(tmp_path):
    """Without a profiler a mapping run keeps no span, yet feeds its
    timers; a span marked `always` (as kernels.load) is kept, with its
    thread and CPU time, and handed out once."""
    index, mo, path = _setup(str(tmp_path))
    mo.flag &= ~O.MM_F_TPU_ALIGN   # chaining alone: the loop's spans
    assert not timeline.profiling()
    timeline.spans()
    met = gp.GpuMetrics()
    assert _map(index, mo, path, met) == 4
    assert timeline.spans() == []
    assert met.t_seed > 0 and met.t_wait > 0 and met.t_finish > 0
    with timeline.span("seed.chunk", 3) as loop:
        pass
    with timeline.span("kernels.load", always=True) as load:
        sum(range(10_000))
    assert timeline.spans() == [load]
    assert timeline.spans() == []
    assert loop.wall_ns >= 0 and loop.thread is None and loop.cpu_ns == 0
    assert load.thread == threading.get_ident() and load.parent is None
    assert 0 < load.wall_ns and 0 <= load.cpu_ns


def test_the_profiler_flag_is_read_where_every_thread_sees_it(monkeypatch):
    """timeline.profiling reads torch.autograd.profiler's module flag, and
    reads False where that private name is missing."""
    import torch.autograd.profiler as ap
    assert ap._is_profiler_enabled is False and not timeline.profiling()
    monkeypatch.setattr(ap, "_is_profiler_enabled", True)
    assert timeline.profiling()
    seen = []
    t = threading.Thread(target=lambda: seen.append(timeline.profiling()))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and seen == [True]
    monkeypatch.delattr(ap, "_is_profiler_enabled")
    assert not timeline.profiling()


def test_spans_are_kept_on_every_thread_with_batches_and_parents(traced):
    spans, main = traced["spans"], traced["main"]
    on = {n: {s.thread for s in _named(spans, n)} for n in
          ("seed.chunk", "seed.read", "dispatch.batch", "dispatch.range",
           "finish.batch", "finish.read", "output.read")}
    assert on["seed.chunk"] == on["finish.batch"] == on["output.read"] \
        == {main}
    pool = (on["seed.read"] | on["finish.read"]) - {main}
    assert main not in on["seed.read"]   # four reads seed on the pool
    assert on["finish.read"] & pool      # so do a batch of two's finishes
    dispatch = on["dispatch.batch"]
    assert len(dispatch) == 1 and not dispatch & (pool | {main})
    assert on["dispatch.range"] == dispatch
    batches = [s.batch for s in _named(spans, "finish.batch")]
    assert len(batches) >= 2 and batches == sorted(set(batches))
    assert [s.batch for s in _named(spans, "dispatch.batch")] == batches
    assert [s.batch for s in _named(spans, "dispatch.wait")] == batches
    assert {s.batch for s in _named(spans, "finish.read")} == set(batches)
    assert {s.batch for s in _named(spans, "seed.read")} <= set(batches)
    for s in spans:
        want = {"dispatch.range": "dispatch.batch",
                "dispatch.pack": "dispatch.batch",
                "dispatch.upload": "dispatch.batch",
                "chain.readback": "finish.batch",
                "fill.collect": "finish.batch",
                "fill.batch": "finish.batch", "fill.table": "finish.batch",
                "finish.slices": "finish.batch"}.get(s.name)
        if want:
            assert s.parent.name == want and s.batch == s.parent.batch
            assert s.parent.thread == s.thread
            assert s.parent.start_ns <= s.start_ns <= s.end_ns \
                <= s.parent.end_ns
        elif s.name in ("seed.chunk", "finish.batch", "dispatch.batch",
                        "output.read"):
            assert s.parent is None
        assert s.cpu_ns >= 0
    assert len(_named(spans, "output.read")) == traced["n_reads"]


def test_every_timer_is_the_sum_of_its_spans(traced):
    """Each timer equals the sum of the spans that feed it, in the order
    they ended; one finish.read a read."""
    met, spans = traced["metrics"], traced["spans"]
    for field, name in FEEDS.items():
        got = _named(spans, name)
        assert got, name
        assert getattr(met, field) == _total(s.wall_s for s in got), field
    assert met.fills.batch_s == _total(s.wall_s
                                       for s in _named(spans, "fill.batch"))
    readback = {id(s.parent): s for s in _named(spans, "chain.readback")}
    assert met.t_finish == _total(
        (s.wall_ns - readback[id(s)].wall_ns) / 1e9
        for s in _named(spans, "finish.batch"))
    assert len(_named(spans, "finish.read")) == traced["n_reads"] == 4
    assert len(_named(spans, "seed.read")) == 4


def test_main_thread_spans_are_in_the_trace_on_its_clock(traced):
    """Every kept span of the main thread is a user_annotation event of
    the exported trace; on the trace's clock (ts, µs, plus
    baseTimeNanoseconds) the event starts inside the span, which reads
    its clock just before it opens the range, and the starts agree
    within 1 ms at the median.  A single start may lag by more: another
    thread may take the interpreter lock, or the OS the core, between
    the clock read and the range's entry.  No span of another thread is
    in the trace."""
    doc, main = traced["trace"], traced["main"]
    base = doc.get("baseTimeNanoseconds", 0)
    slack = 0.25e6   # ns: the trace's conversion of its own clock
    marks = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation":
            marks.setdefault(e["name"], []).append(e["ts"] * 1e3 + base)
    mine = [s for s in traced["spans"] if s.thread == main]
    assert {s.name for s in mine} >= {"seed.chunk", "finish.batch",
                                      "fill.collect", "output.read"}
    lags = []
    for s in mine:
        inside = [t - s.start_ns for t in marks[s.name]
                  if s.start_ns - slack <= t <= s.end_ns + slack]
        assert inside, s.name
        lags.append(min(inside, key=abs))
    assert sorted(abs(x) for x in lags)[len(lags) // 2] < 1e6
    others = {s.name for s in traced["spans"] if s.thread != main}
    assert others >= {"seed.read", "dispatch.batch"}
    assert not others & {"seed.read", "dispatch.batch", "dispatch.range",
                         "dispatch.pack", "dispatch.upload"} & set(marks)


def test_a_profiled_cli_run_keeps_no_loop_span(tmp_path):
    """Within trace_only (cli's --tpu-profile) a main-thread span is a
    range of the profiler's trace and no loop span is kept, on any
    thread; a span marked `always` still is, and keeping resumes after."""
    from torch.profiler import ProfilerActivity, profile
    index, mo, path = _setup(str(tmp_path))
    timeline.spans()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with timeline.trace_only():
            assert _map(index, mo, path, gp.GpuMetrics()) == 4
            with timeline.span("kernels.load", always=True) as load:
                pass
        with timeline.span("output.read") as after:
            pass
    finally:
        prof.stop()
    assert timeline.spans() == [load, after]
    trace = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert names >= {"seed.chunk", "finish.batch", "fill.collect",
                     "output.read", "kernels.load"}


def test_cli_profile_writes_the_main_thread_spans(tmp_path):
    """--gpu-profile DIR (cli._run on the CPU twins): the trace names the
    main thread's stages, and the run leaves no loop span behind."""
    _index, _mo, path = _setup(str(tmp_path))
    ref = tmp_path / "ref.fa"
    ref.write_text(">c\n" + random_reference(30_000, seed=51) + "\n")
    prof = tmp_path / "prof"
    argv, args = cli.parse_args(["--max-chain-skip=2147483647",
                                 "--gpu-chain", "-t", "2", "--gpu-profile",
                                 str(prof), str(ref), path])
    io_, mo = O.set_preset(args.preset)
    timeline.spans()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli._run(args, argv, io_, mo, torch.device("cpu"))
    assert rc == 0 and out.getvalue().count("\n") >= 4, err.getvalue()
    with open(prof / "trace.json") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert names >= {"seed.chunk", "finish.batch", "output.read"}
    assert [s.name for s in timeline.spans()] == []


def test_timeline_imports_no_torch():
    """The host route records its output spans without torch loaded."""
    code = ("import sys\n"
            "from mm2_gb_tpu_torch.utils import timeline\n"
            "with timeline.span('kernels.load', always=True):\n"
            "    pass\n"
            "with timeline.span('output.read'):\n"
            "    pass\n"
            "assert not timeline.profiling()\n"
            "assert [s.name for s in timeline.spans()] == ['kernels.load']\n"
            "assert 'torch' not in sys.modules, 'torch'\n")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=60)
    assert r.returncode == 0, r.stderr
