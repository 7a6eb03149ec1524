"""dispatch_s_per_gbp: range selection and cutting, the upload buffer's
packing, and the upload and launch (GpuMetrics.t_range + t_pack +
t_dispatch, chain_gpu.dispatch_scores on the dispatch thread) per Gbp
emitted in the window."""


def read(ctx):
    m = ctx.metrics
    return (m.t_range + m.t_pack + m.t_dispatch) / ctx.gbp if ctx.gbp \
        else None
