"""index_s: MinimizerIndex.build of the genome and mapopt_update
(harness clock)."""


def read(ctx):
    return ctx.clock["index_s"]
