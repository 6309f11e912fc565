"""Mean time a batch fetch spent after its wait for the window
(``SessionMetrics.fetch_s - fetch_pump_s``): retiring the previous step,
the borrow, the host-to-device copy, the reassembly launch and the
lookahead request. Over the window's sessions that a fetch consumed; None
where no session carries the stamps."""


def read(ctx):
    got = [s.fetch_s - s.fetch_pump_s for s in ctx.sessions
           if getattr(s, "fetch_s", 0.0) > 0]
    if not got:
        return None
    return sum(got) / len(got) * 1e3
