"""finish_s_per_gbp: the host finish of each batch (backtrack, rescue,
alignment from the fill table, post-processing: pipeline.finish_slices)
per Gbp emitted, as GpuMetrics.t_finish less the fill collect pass, the
fill batch calls and the table load it holds."""


def read(ctx):
    m = ctx.metrics
    if not ctx.gbp:
        return None
    return (m.t_finish - m.t_collect - ctx.fills.batch_s - m.t_table) \
        / ctx.gbp
