"""startup_s: process start to torch, the port and CUDA loaded, plus
gpucfg.derive_caps and the kernel library's load (harness clock)."""


def read(ctx):
    return ctx.clock["startup_s"]
