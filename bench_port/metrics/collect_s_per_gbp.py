"""collect_s_per_gbp: the C++ aligner's collect pass of the gap fills
(pipeline._prefill_native, GpuMetrics.t_collect) per Gbp emitted; only
where the run has gap fills."""


def read(ctx):
    if not ctx.fills.fills or not ctx.gbp:
        return None
    return ctx.metrics.t_collect / ctx.gbp
