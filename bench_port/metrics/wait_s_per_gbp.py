"""wait_s_per_gbp: the host blocked on the chain results
(PendingScores.collect, GpuMetrics.t_wait) per Gbp emitted."""


def read(ctx):
    return ctx.metrics.t_wait / ctx.gbp if ctx.gbp else None
