"""Committed frames over slots x frames a chunk x chunk calls, in the
traced window: the share of the engine's packed grid that carried frames."""
UNIT, SOURCE, BETTER = '%', 'program_counter', 'higher'
LAYER, MOVES = 'engine', 'frames_per_s'


def read(ctx):
    t = ctx.traced
    if t is None or not t.calls:
        return None
    return 100.0 * t.frames / sum(T * B for T, B, _ in t.calls)
