"""Tokens of every step completed in the window over the window's
measured length. Host clock."""


def read(ctx):
    return ctx.steps * ctx.tokens_per_step / ctx.window_s
