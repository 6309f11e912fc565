"""Set-up: from the process start to the window's start (imports, the
corpus written and read back, the reader pipeline, weights and moments
made on the card, the first steps with any kernel build). Host clock."""


def read(ctx):
    return ctx.setup_s
