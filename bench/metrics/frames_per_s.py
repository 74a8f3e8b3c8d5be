"""Every frame whose log-probs were committed in the measured window,
over the window's seconds (host clock)."""
UNIT, SOURCE, BETTER = 'frames/s', 'host_clock', 'higher'


def read(ctx):
    if not ctx.frames or not ctx.window_s:
        return None
    return ctx.frames / ctx.window_s
