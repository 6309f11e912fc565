"""Mean time a batch fetch spent parked on CkIO's scheduler, waiting for
reader threads (``SessionMetrics.fetch_parked_s``): the part of the read
the trainer waited for. Over the window's sessions that a fetch consumed;
None where no session carries the stamps."""


def read(ctx):
    got = [s.fetch_parked_s for s in ctx.sessions
           if getattr(s, "fetch_s", 0.0) > 0]
    if not got:
        return None
    return sum(got) / len(got) * 1e3
