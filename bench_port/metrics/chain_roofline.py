"""chain_roofline: the chain kernel's share of its roofline, in %: the
least time for the work of every batch the window collected (the
benchmark's frozen count, roofline.chain_work) over the kernel's time
(GpuMetrics.t_kernel, CUDA events around each launch)."""

from bench_port import roofline


def read(ctx):
    calls = [c[1:] for c in ctx.window.cap.chain_calls if c[0].collected]
    return roofline.share(*roofline.chain_work(calls), ctx.metrics.t_kernel)
