"""kernel_s_per_gbp: the card's time in the port's kernels per Gbp
emitted in the window: the chain kernel (GpuMetrics.t_kernel) and the
gap-fill, extension and backtrack kernels (FillStats.fill_ms, ext_ms,
backtrack_ms, ext_backtrack_ms), each timed by CUDA events around its
launch.  Nothing where no kernel ran (the CPU's twins)."""


def read(ctx):
    f = ctx.fills
    s = ctx.metrics.t_kernel + (f.fill_ms + f.ext_ms + f.backtrack_ms
                                + f.ext_backtrack_ms) / 1e3
    return s / ctx.gbp if s > 0 and ctx.gbp else None
