"""output_s_per_gbp: the SAM or PAF writing of every emitted read
(cli.res_regs_out, the program's `output.read` spans on the main
thread) per Gbp emitted in the traced window."""

from bench_port import spans as S


def read(ctx):
    spans = S.program_spans(ctx)
    if spans is None or not ctx.gbp:
        return None
    s = S.total(spans, "output.read")
    return s / ctx.gbp if s is not None else None
