"""The device: 1 - (the union of kernel, copy and set intervals on the card)
/ the window, from `torch.profiler` with CUDA activity only."""


def read(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
