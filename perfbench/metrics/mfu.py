"""Model FLOPs of the window's steps (the configuration's own count in
``counts/<config>.py``, no recompute) over the window's length and the
card's dense bf16 peak, in percent. The traced run's unprofiled window."""


def read(ctx):
    flops = ctx.counts(ctx.spec.config["name"]).step_flops(ctx.model,
                                                          ctx.traffic)
    return flops * ctx.steps / ctx.window_s / ctx.hw["bf16_flops_per_s"] * 100
