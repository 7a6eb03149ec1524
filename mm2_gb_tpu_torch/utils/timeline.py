"""Env-gated phase timeline (MM2TPU_TIMELINE=1): one stderr line per
phase boundary with seconds since PROCESS start (so interpreter + site
hook cost shows up before the first mark).  Diagnostic only — stdout
(the byte contract) is never touched."""

import contextlib
import os
import sys
import threading
import time

_ON = os.environ.get("MM2TPU_TIMELINE", "") == "1"


def _proc_elapsed() -> float:
    """Seconds since the process started (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


_T0 = time.perf_counter() - _proc_elapsed()


def mark(msg: str) -> None:
    if _ON:
        sys.stderr.write(f"[T::{time.perf_counter() - _T0:7.2f}s] {msg}\n")
        sys.stderr.flush()


# Spans: the stages of a run, each where it runs, on the clock of a torch
# profiler's trace (time.time_ns)
_SPANS = []
_local = threading.local()
_keep = True   # keep the loop's spans under a profiler (trace_only)


def profiling() -> bool:
    """Whether a torch profiler runs: torch.autograd.profiler's module
    flag, which every thread reads (torch._C._autograd._profiler_enabled
    reads True on the profiler's own thread alone); False where torch is
    not loaded, or where the flag has no such name."""
    return bool(getattr(sys.modules.get("torch.autograd.profiler"),
                        "_is_profiler_enabled", False))


class span:
    """One stage of a run, a context manager: `span(name, batch)` is a
    span of stage `name` in batch `batch` (-1: none, or the parent's).

    Every span reads the wall clock (time.time_ns) on entry and exit, so
    its caller adds `wall_s` to the counter it feeds.  It is kept, for
    `spans`, where `always` is set or while a torch profiler runs
    (outside `trace_only`); a kept span also holds its thread's id, the
    CPU time that thread spent in it (time.thread_time_ns), the kept
    span it opened in on that thread (`parent`), and takes its parent's
    batch where it names none.  While a profiler runs, a span on the
    thread that started it is also a record_function range, so the
    profiler's trace shows it under its name; ranges opened on other
    threads do not reach the trace.  A span must not stay open across a
    generator's yield.  `always`: keep it without a profiler too, for a
    stage outside the mapping loop that runs a few times a process."""

    __slots__ = ("name", "batch", "always", "thread", "parent",
                 "start_ns", "end_ns", "cpu_ns", "_cpu0", "_range")

    def __init__(self, name: str, batch: int = -1, always: bool = False):
        self.name, self.batch, self.always = name, batch, always
        self.thread = self.parent = self._range = None
        self.start_ns = self.end_ns = self.cpu_ns = self._cpu0 = 0

    def __enter__(self) -> "span":
        traced = profiling()
        if self.always or (traced and _keep):
            stack = _local.__dict__.setdefault("stack", [])
            self.parent = stack[-1] if stack else None
            if self.batch < 0 and self.parent is not None:
                self.batch = self.parent.batch
            self.thread = threading.get_ident()
            stack.append(self)
            self._cpu0 = time.thread_time_ns()
        self.start_ns = time.time_ns()
        if traced:
            torch = sys.modules.get("torch")
            if torch is not None and torch._C._autograd._profiler_enabled():
                self._range = torch.autograd.profiler.record_function(
                    self.name)
                self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        if self.thread is not None:
            self.cpu_ns = time.thread_time_ns() - self._cpu0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self.thread is not None:
            _local.stack.pop()
            _SPANS.append(self)

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def wall_s(self) -> float:
        return self.wall_ns / 1e9

    @property
    def cpu_s(self) -> float:
        """The thread's CPU seconds in the span (0 where not kept)."""
        return self.cpu_ns / 1e9


def spans() -> list:
    """The kept spans, in the order they ended, taken out of the record:
    each is handed out once, and the caller holds what it took."""
    n = len(_SPANS)
    out = _SPANS[:n]
    del _SPANS[:n]
    return out


@contextlib.contextmanager
def trace_only():
    """Within it, a span of the loop is kept by no one: under a profiler
    it is a range of the profiler's trace alone.  For a profiled run that
    reads no spans (cli's --tpu-profile), whose record would otherwise
    grow with its reads."""
    global _keep
    _keep = False
    try:
        yield
    finally:
        _keep = True


if _ON:
    import atexit
    atexit.register(lambda: mark("exit"))
