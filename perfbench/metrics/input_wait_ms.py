"""Mean host time in ``CkIOPipeline.get_batch_device`` over the window's
steps: the benchmark's own span, taken as the loop runs (the loss read
before it leaves the card idle while it runs)."""


def read(ctx):
    if not ctx.input_s:
        return None
    return sum(ctx.input_s) / len(ctx.input_s) * 1e3
