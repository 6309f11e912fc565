"""Mean checkout of a pooled session on the reader service (submit to
every worker attached, ``SessionMetrics.service_checkout_s``) over the
window's pooled sessions."""


def read(ctx):
    got = [s.service_checkout_s for s in ctx.sessions if s.pooled]
    if not got:
        return None
    return sum(got) / len(got) * 1e3
