"""finish_cores: the cores the host finish keeps busy: the CPU seconds of
every read's `finish.read` span (backtrack, rescue, alignment from the
fill table, post-processing, on the pool's threads) over the wall
seconds of the `finish.slices` spans that wait for them on the main
thread, in the traced window."""

from bench_port import spans as S


def read(ctx):
    return S.cores(ctx, "finish.read", "finish.slices")
