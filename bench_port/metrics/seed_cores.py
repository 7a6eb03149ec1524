"""seed_cores: the cores seeding keeps busy: the CPU seconds of every
read's `seed.read` span (sketch and anchor collection, on the pool's
threads) over the wall seconds of the `seed.chunk` spans that wait for
them on the main thread, in the traced window."""

from bench_port import spans as S


def read(ctx):
    return S.cores(ctx, "seed.read", "seed.chunk")
