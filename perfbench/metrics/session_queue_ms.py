"""Mean wait of a requested CkIO window before its reads could begin:
``SessionMetrics.t_start - t_requested`` (the pipeline's ``start_step``
stamp), over the window's sessions that carry both, as the Director's
observer hands them over. None where no session carries the stamp."""


def read(ctx):
    got = [s.t_start - s.t_requested for s in ctx.sessions
           if getattr(s, "t_requested", 0.0) and s.t_start]
    if not got:
        return None
    return sum(got) / len(got) * 1e3
