"""Mean CkIO read session, start to last byte (``SessionMetrics.
ingest_seconds``), over the sessions that closed in the window, as the
Director's observer hands them over."""


def read(ctx):
    got = [s.ingest_seconds() for s in ctx.sessions if s.t_last_read]
    if not got:
        return None
    return sum(got) / len(got) * 1e3
