"""The port's own spans (mm2_gb_tpu_torch.utils.timeline.spans) for the
`program_span` metrics that read them.

The program keeps a span of the mapping loop only while a torch profiler
runs, so in a traced run the loop's spans are the window's; a span
outside the loop (`kernels.load`) is kept in every run.  The program
hands each kept span out once: the first reader of a run takes them all
into its context (`ctx.program_spans`), where the others find them.  A
tree whose timeline records no spans gives None, and so does every
reader."""

from __future__ import annotations


def program_spans(ctx) -> list | None:
    """The spans the program kept in this run, or None where it keeps
    none."""
    if not hasattr(ctx, "program_spans"):
        from mm2_gb_tpu_torch.utils import timeline
        get = getattr(timeline, "spans", None)
        ctx.program_spans = get() if get is not None else None
    return ctx.program_spans


def total(spans: list, name: str, what: str = "wall_s") -> float | None:
    """The wall seconds (`what` "cpu_s": the CPU seconds of their
    threads) of the spans named `name`, None where none is."""
    got = [getattr(s, what) for s in spans if s.name == name]
    return sum(got) if got else None


def cores(ctx, work: str, over: str) -> float | None:
    """The CPU seconds of the spans `work` over the wall seconds of the
    spans `over`: the cores busy on `work` while `over` ran."""
    spans = program_spans(ctx)
    if spans is None:
        return None
    cpu, wall = total(spans, work, "cpu_s"), total(spans, over)
    return cpu / wall if cpu is not None and wall else None
