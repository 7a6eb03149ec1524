"""kernel_load_s: the kernel library's load in set-up (the program's
`kernels.load` span, utils/kernels.library: the extension builder's
import, its up-to-date check or build, and the library's opening)."""

from bench_port import spans as S


def read(ctx):
    spans = S.program_spans(ctx)
    return S.total(spans, "kernels.load") if spans is not None else None
