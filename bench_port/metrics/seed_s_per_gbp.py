"""seed_s_per_gbp: GpuMetrics.t_seed (sketch and anchor collection on
the main thread, pipeline._acc_batches) per Gbp emitted in the window.
The counters run one batch ahead of the emissions (the batch in flight
was seeded), as in every run."""


def read(ctx):
    return ctx.metrics.t_seed / ctx.gbp if ctx.gbp else None
