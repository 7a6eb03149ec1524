"""Env-gated phase timeline (MM2TPU_TIMELINE=1): one stderr line per
phase boundary with seconds since PROCESS start (so interpreter + site
hook cost shows up before the first mark).  Diagnostic only — stdout
(the byte contract) is never touched."""

import os
import sys
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


if _ON:
    import atexit
    atexit.register(lambda: mark("exit"))
