"""1 - the union of the card's kernel and copy intervals over the span of
the profiled steps (after the first), in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    return (1 - ctx.trace["busy_s"] / ctx.trace["window_s"]) * 100
