"""device_idle_pct: the share of the traced window in which no kernel,
copy or set ran on the card, from torch.profiler's trace (where the
trace shows no device time, the harness takes the kernels' CUDA-event
times instead)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
