"""fill_roofline: the gap-fill kernel's share of its roofline, in %: the
least time for the fills of every batch in the window (the benchmark's
frozen count, roofline.fill_work) over the fill kernel's time
(FillStats.fill_ms, CUDA events around each launch)."""

from bench_port import roofline


def read(ctx):
    return roofline.share(*roofline.fill_work(ctx.window.cap.fill_metas),
                          ctx.fills.fill_ms / 1e3)
