"""host_cpu_s_per_gbp: the process's user and system CPU seconds over
the window (resource.getrusage) per Gbp emitted."""


def read(ctx):
    return ctx.window.cpu_s / ctx.gbp if ctx.gbp else None
