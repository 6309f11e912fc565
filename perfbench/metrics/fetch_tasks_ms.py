"""Mean time a batch fetch spent running CkIO's scheduler tasks on the
trainer's thread (``SessionMetrics.fetch_pump_s - fetch_parked_s``: the
pump less its parked time). Over the window's sessions that a fetch
consumed; None where no session carries the stamps."""


def read(ctx):
    got = [s.fetch_pump_s - s.fetch_parked_s for s in ctx.sessions
           if getattr(s, "fetch_s", 0.0) > 0]
    if not got:
        return None
    return sum(got) / len(got) * 1e3
