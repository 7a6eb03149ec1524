"""window_mbp_s: query bases of every read emitted in the window, over
the time from the window's start to the last emission, in Mbp/s: the
mapping rate, which the host's stages hold (a per-layer metric: its
runs spread too widely between processes to bound it end to end)."""


def read(ctx):
    w = ctx.window
    return w.bases / w.seconds / 1e6 if w.seconds > 0 else None
